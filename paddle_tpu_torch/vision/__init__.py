"""Vision of the port (``paddle_tpu/vision/``): the models, the host-side
image functionals and transforms, and the datasets."""
from . import datasets  # noqa: F401
from . import functional  # noqa: F401
from . import models  # noqa: F401
from . import transforms  # noqa: F401
