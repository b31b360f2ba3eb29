"""Host-side data feed of the port: in-memory datasets, batching and the
language models' text pipeline."""

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalArrayDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.text import (Dictionary, LabeledSentence,
                                          LabeledSentenceToTokens,
                                          WordTokenizer, load_in_data,
                                          read_sentence)
from bigdl_tpu_torch.dataset.transformer import (MiniBatch, Sample,
                                                 SampleToBatch, Transformer)

__all__ = ["AbstractDataSet", "DataSet", "Dictionary", "LabeledSentence",
           "LabeledSentenceToTokens", "LocalArrayDataSet", "MiniBatch",
           "Sample", "SampleToBatch", "TransformedDataSet", "Transformer",
           "WordTokenizer", "load_in_data", "read_sentence"]
