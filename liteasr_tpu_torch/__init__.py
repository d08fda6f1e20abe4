"""liteasr_tpu_torch: the PyTorch/CUDA port of liteasr_tpu.

The JAX package ``liteasr_tpu`` is the reference; this package imports
neither it nor jax/flax. Importing the package populates the component
registries under the same names, so the reference's presets (``model=my_U2``,
``task=asr``) resolve unchanged.
"""

__version__ = "0.1.0"

from liteasr_tpu_torch.config import config_init as _config_init

_config_init()

import liteasr_tpu_torch.data.transform  # noqa: E402,F401
import liteasr_tpu_torch.models  # noqa: E402,F401
import liteasr_tpu_torch.tasks  # noqa: E402,F401
