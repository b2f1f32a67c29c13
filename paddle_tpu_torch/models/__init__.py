from .bert import (BertConfig, BertEmbeddings,  # noqa: F401
                   BertForPretraining, BertModel, ErnieModel)
from .convert import (load_numpy_optimizer_state,  # noqa: F401
                      load_numpy_state)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel  # noqa: F401
