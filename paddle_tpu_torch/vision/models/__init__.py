"""Vision models of the port (``paddle_tpu/vision/models/``): every model
of the reference's zoo, with its module names, so a state carries across
by name (``utils.convert.state_dict_by_name``). Each constructor takes
``device`` (None: the card) and ``seed``; ``pretrained=True`` raises."""
from ...models.lenet import LeNet  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .densenet import (DenseNet, densenet121, densenet161, densenet169, densenet201,  # noqa: F401
                       densenet264)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2, MobileNetV3, mobilenet_v1, mobilenet_v2,  # noqa: F401
                        mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
    resnext152_64x4d, wide_resnet50_2, wide_resnet101_2)
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_x0_5, shufflenet_v2_x1_0,  # noqa: F401
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
