"""The encoder builder, GPT decoder weights and the shared decode math."""

from flexflow_tpu_torch.models.gpt_decode import GPTSpec, layer_norm, make_cast
from flexflow_tpu_torch.models.transformer import (
    BERT_BASE,
    BERT_LARGE,
    GPT2_MEDIUM,
    GPT2_SMALL,
    GPTDecoder,
    encoder_layer,
    load_jax_params,
    transformer_encoder,
)

__all__ = [
    "GPTSpec", "layer_norm", "make_cast",
    "BERT_BASE", "BERT_LARGE", "encoder_layer", "transformer_encoder",
    "GPT2_SMALL", "GPT2_MEDIUM", "GPTDecoder", "load_jax_params",
]
