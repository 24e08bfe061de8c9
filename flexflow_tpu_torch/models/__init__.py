"""The model builders (the encoder and decoder, MLP, the CNN zoo, DLRM
and XDL, CANDLE-Uno, the MoE models), generation, GPT decoder weights and
the shared decode math."""

from flexflow_tpu_torch.models.candle_uno import candle_uno
from flexflow_tpu_torch.models.cnn import alexnet, inception_v3, resnet, resnext50
from flexflow_tpu_torch.models.dlrm import dlrm, xdl
from flexflow_tpu_torch.models.gpt_decode import GPTSpec, layer_norm, make_cast
from flexflow_tpu_torch.models.mlp import mlp
from flexflow_tpu_torch.models.moe import moe_classifier, moe_encoder
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
    "mlp", "alexnet", "resnet", "resnext50", "inception_v3", "dlrm", "xdl", "candle_uno",
    "moe_classifier", "moe_encoder",
]
