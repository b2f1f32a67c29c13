from .bert import (BertConfig, BertEmbeddings,  # noqa: F401
                   BertForPretraining, BertModel, ErnieModel)
from .convert import (load_numpy_optimizer_state,  # noqa: F401
                      load_numpy_state)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
from .interop import load_hf_bert, load_hf_gpt2  # noqa: F401
