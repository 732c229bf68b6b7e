"""Model families (counterpart of ``mxnet_tpu/models``): Llama (with the
Mixtral MoE configs), MoE, Transformer and BERT.  FM comes with a later
slice (ROADMAP Queue 1 item 8g)."""
from . import llama
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaDecoder, llama3_8b,
                    llama_tiny, mixtral_8x7b, mixtral_tiny)
from . import moe
from . import transformer
from . import bert
