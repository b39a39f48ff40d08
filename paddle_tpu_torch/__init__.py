"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

It mirrors the JAX package's module paths. Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper (``csrc/``, built at first use by ``ops/cuda/_build.py``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.

The port covers GPT serving (``models.GPTForCausalLM``,
``serving.GenerationEngine`` and ``serving.Scheduler``) and GPT training:
``GPTForCausalLM.loss`` (the chunked fused loss, or the flash-CE kernels
under ``FLAGS_enable_flash_ce``), the optimizers with LR schedulers,
gradient clipping and regularizers, ``amp`` (``auto_cast``, ``decorate``,
``GradScaler``) and ``io.DeviceLoader``; and the encoder family:
``nn.Transformer`` and its layers, BERT (``models.BertForPretraining``,
``BertForSequenceClassification`` behind ``serving.EncoderScorer``) and
ERNIE (``models.ErnieForPretraining`` and its heads); and the vision path:
``vision.models`` (LeNet, the ResNet family) on ``nn``'s convolutions, batch
norms and pooling, with ``incubate.autotune``'s layout autotune
(channels-last convolutions). It imports neither ``jax`` nor
``paddle_tpu``.
"""
from . import (amp, framework, incubate, io, models, nn, ops,  # noqa: F401
               optimizer, regularizer, serving, vision)
from .framework.random import (  # noqa: F401
    get_cuda_rng_state, get_rng_state, seed, set_cuda_rng_state, set_rng_state)

__all__ = ["amp", "framework", "incubate", "io", "models", "nn", "ops",
           "optimizer", "regularizer", "serving", "vision", "seed",
           "get_rng_state", "set_rng_state", "get_cuda_rng_state",
           "set_cuda_rng_state"]
