"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

It mirrors the JAX package's module paths. Plain tensor code is PyTorch;
every Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper (``csrc/``, built at first use by ``ops/cuda/_build.py``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.

The port covers GPT serving (``models.GPTForCausalLM``,
``serving.GenerationEngine`` and ``serving.Scheduler``) and the GPT train
step (``GPTForCausalLM.loss``, ``optimizer.AdamW`` with multi_precision,
``io.DeviceLoader``). It imports neither ``jax`` nor ``paddle_tpu``.
"""
from . import framework, io, models, nn, ops, optimizer, serving  # noqa: F401

__all__ = ["framework", "io", "models", "nn", "ops", "optimizer", "serving"]
