"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

It mirrors ``paddle_tpu``'s subpackage layout so each module has one
counterpart there, and it never imports ``jax`` or ``paddle_tpu``. Every
Pallas kernel of a ported path is a hand-written CUDA kernel under ``csrc/``,
built by ``nvcc`` at first use. Entry points (``models.gpt.GPTForPretraining``,
``models.bert.BertForPretraining``, ``models.ernie.ErnieForPretraining``,
``vision.models.resnet50`` and the other ResNets, ``models.lenet.LeNet``,
``inference.DecodeEngine``) run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
