"""paddle.distributed.launch of the port (``paddle_tpu/distributed/launch``;
reference: python/paddle/distributed/launch/main.py:18 +
controllers/collective.py + fleet/elastic/manager.py:131).

``python -m paddle_tpu_torch.distributed.launch --nnodes N train.py`` spawns
one worker process per local slot with the rendezvous environment
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``,
``PADDLE_LOCAL_RANK``, ``PADDLE_NNODES``, which
``distributed/env.py:init_parallel_env`` reads), watches them, and:

- with ``--elastic_retries N`` relaunches the whole job on a worker's death
  (``ElasticManager``);
- with ``--elastic_np min:max`` keeps the nodes' membership in a TCPStore
  (at ``--master``'s port + 2) and relaunches the workers with rescaled
  ranks whenever it changes (``ElasticMembershipManager``); a SIGTERM makes
  the node leave at once;
- with ``--serve spec.json`` boots serving replicas instead
  (``ServeController``), which ``ProcServingFleet.attach`` adopts.

One worker process per card; several workers may share ``cuda:0`` over
gloo. The launcher and its workers import neither ``jax`` nor
``paddle_tpu``."""
from .main import launch, main  # noqa: F401
