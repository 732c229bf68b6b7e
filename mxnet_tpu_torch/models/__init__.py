"""Model families (counterpart of ``mxnet_tpu/models``).  The Llama
inference path is ported; Transformer, BERT, MoE and FM come with later
slices (ROADMAP Queue 1)."""
from . import llama
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaDecoder, llama3_8b,
                    llama_tiny)
