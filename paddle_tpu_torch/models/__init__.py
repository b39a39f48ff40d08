"""Models of the port: GPT (``gpt.py``) and the encoder family, BERT
(``bert.py``) and ERNIE (``ernie.py``)."""
from .bert import (  # noqa: F401
    BertConfig,
    BertEmbeddings,
    BertForPretraining,
    BertForSequenceClassification,
    BertModel,
    BertPooler,
    bert_base,
    bert_large,
)
from .convert import load_jax_optimizer_state, load_jax_state  # noqa: F401
from .ernie import (  # noqa: F401
    ErnieConfig,
    ErnieDataCollator,
    ErnieEmbeddings,
    ErnieForPretraining,
    ErnieForQuestionAnswering,
    ErnieForSequenceClassification,
    ErnieForTokenClassification,
    ErnieLMPredictionHead,
    ErnieModel,
    ErniePooler,
    ernie_base,
    ernie_large,
)
from .gpt import (  # noqa: F401
    GPTConfig,
    GPTDecoderLayer,
    GPTEmbeddings,
    GPTForCausalLM,
    GPTModel,
)
