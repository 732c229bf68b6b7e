"""Model families (counterpart of ``mxnet_tpu/models``): Llama (with the
Mixtral MoE configs), MoE, Transformer, BERT and the factorization
machine (``fm``), with the reference's re-exports."""
from . import llama
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaDecoder, llama3_8b,
                    llama_tiny, mixtral_8x7b, mixtral_tiny)
from . import moe
from . import transformer
from .transformer import Transformer
from . import bert
from .bert import (BERTModel, BERTClassifier, bert_base, bert_large,
                   bert_tiny)
from . import fm
from .fm import FMModel
