from .flags import flag_value, get_flags, register_flag, set_flags  # noqa: F401
from .place import resolve_device  # noqa: F401
from .random import (  # noqa: F401
    get_cuda_rng_state, get_rng_state, seed, set_cuda_rng_state, set_rng_state)
