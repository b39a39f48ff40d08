"""Models of the port."""
from .convert import load_jax_optimizer_state, load_jax_state  # noqa: F401
from .gpt import (  # noqa: F401
    GPTConfig,
    GPTDecoderLayer,
    GPTEmbeddings,
    GPTForCausalLM,
    GPTModel,
)
