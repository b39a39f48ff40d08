"""``paddle_tpu_torch.nn.utils`` — port of ``paddle_tpu/nn/utils/``: the
weight-norm and spectral-norm reparameterisations (forward pre-hooks) and
the parameter <-> vector transforms."""
from .spectral_norm_hook import spectral_norm  # noqa: F401
from .transform_parameters import (  # noqa: F401
    parameters_to_vector,
    vector_to_parameters,
)
from .weight_norm_hook import remove_weight_norm, weight_norm  # noqa: F401
