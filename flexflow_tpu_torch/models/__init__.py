"""The encoder and decoder builders, generation, GPT decoder weights and
the shared decode math."""

from flexflow_tpu_torch.models.gpt_decode import GPTSpec, layer_norm, make_cast
from flexflow_tpu_torch.models.transformer import (
    BERT_BASE,
    BERT_LARGE,
    GPT2_MEDIUM,
    GPT2_SMALL,
    GPTDecoder,
    decoder_layer,
    encoder_layer,
    gpt_decoder,
    gpt_generate,
    load_jax_params,
    sample_next,
    transformer_encoder,
)

__all__ = [
    "GPTSpec", "layer_norm", "make_cast",
    "BERT_BASE", "BERT_LARGE", "encoder_layer", "transformer_encoder",
    "GPT2_SMALL", "GPT2_MEDIUM", "decoder_layer", "gpt_decoder", "sample_next",
    "gpt_generate", "GPTDecoder", "load_jax_params",
]
