"""GPT decoder weights and the shared decode math."""

from flexflow_tpu_torch.models.gpt_decode import GPTSpec, layer_norm, make_cast
from flexflow_tpu_torch.models.transformer import (
    GPT2_MEDIUM,
    GPT2_SMALL,
    GPTDecoder,
    load_jax_params,
)

__all__ = [
    "GPTSpec", "layer_norm", "make_cast",
    "GPT2_SMALL", "GPT2_MEDIUM", "GPTDecoder", "load_jax_params",
]
