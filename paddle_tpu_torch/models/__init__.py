"""Model zoo of the port: GPT (training model and configurations) and
BERT/ERNIE (pretraining and classification)."""

from .bert import (BertConfig, BertEmbeddings, BertForPretraining,
                   BertForSequenceClassification, BertLayer, BertModel,
                   BertPooler, BertPretrainingCriterion, BertSelfAttention,
                   ErnieConfig, ErnieForPretraining,
                   ErnieForSequenceClassification, ErnieModel,
                   ErniePretrainingCriterion, bert_base,
                   bert_state_dict_from_jax, bert_tiny, ernie_3_base)
from .gpt import (GPTAttention, GPTConfig, GPTDecoderLayer, GPTEmbeddings,
                  GPTForCausalLM, GPTMLP, GPTModel, GPTPretrainingCriterion,
                  enable_fused_lmce, gpt2_small, gpt3_1p3b, gpt_tiny,
                  init_decode_weights_numpy, state_dict_from_jax)

__all__ = ["GPTConfig", "gpt_tiny", "gpt2_small", "gpt3_1p3b",
           "init_decode_weights_numpy", "GPTEmbeddings", "GPTAttention",
           "GPTMLP", "GPTDecoderLayer", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "enable_fused_lmce",
           "state_dict_from_jax",
           "BertConfig", "bert_tiny", "bert_base", "ernie_3_base",
           "BertEmbeddings", "BertSelfAttention", "BertLayer", "BertPooler",
           "BertModel", "BertForPretraining", "BertPretrainingCriterion",
           "BertForSequenceClassification", "bert_state_dict_from_jax",
           "ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "ErniePretrainingCriterion", "ErnieForSequenceClassification"]
