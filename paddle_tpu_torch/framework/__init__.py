from .dtype import (convert_dtype, get_default_dtype,  # noqa: F401
                    set_default_dtype)
from .flags import flag_value, get_flags, register_flag, set_flags  # noqa: F401
from .io import CheckpointCorruptError, load, save  # noqa: F401
from .place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place,  # noqa: F401
                    get_device, resolve_device, set_device)
from .random import (  # noqa: F401
    get_cuda_rng_state, get_rng_state, seed, set_cuda_rng_state, set_rng_state)
from .tensor import Parameter, Tensor, is_tensor, to_tensor  # noqa: F401
