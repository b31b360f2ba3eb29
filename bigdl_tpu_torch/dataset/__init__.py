"""Host-side data feed of the port: in-memory datasets, batching and the
language models' text pipeline."""

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalArrayDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.text import (Dictionary, LabeledSentence,
                                          LabeledSentenceToSample,
                                          LabeledSentenceToTokens,
                                          WordTokenizer, load_in_data,
                                          read_sentence, shaping, to_tokens,
                                          vectorization)
from bigdl_tpu_torch.dataset.transformer import (MiniBatch, Sample,
                                                 SampleToBatch, Transformer)

__all__ = ["AbstractDataSet", "DataSet", "Dictionary", "LabeledSentence",
           "LabeledSentenceToSample", "LabeledSentenceToTokens",
           "LocalArrayDataSet", "MiniBatch", "Sample", "SampleToBatch",
           "TransformedDataSet", "Transformer", "WordTokenizer",
           "load_in_data", "read_sentence", "shaping", "to_tokens",
           "vectorization"]
