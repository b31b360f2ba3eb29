"""Host-side data feed of the port: in-memory and record-file datasets,
batching, the image pipeline, the record files (``seqfile``,
``hadoop_seqfile``), the multi-threaded batcher and the prefetch to the
card (``prefetch``), the sharded multi-process feed (``sharded``,
``ingest_pool``, ``staging``), the MNIST/CIFAR-10/20 Newsgroups parsers and
the language models' text pipeline."""

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalArrayDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.image import (BGRImgCropper, BGRImgNormalizer,
                                           BGRImgPixelNormalizer,
                                           BGRImgRdmCropper, BGRImgToBatch,
                                           BGRImgToImageVector, ByteRecord,
                                           BytesToBGRImg, BytesToGreyImg,
                                           ColorJitter, GreyImgCropper,
                                           GreyImgNormalizer, GreyImgToBatch,
                                           HFlip, LabeledBGRImage,
                                           LabeledGreyImage, LabeledImage,
                                           Lighting, LocalImgReader,
                                           image_folder_paths)
from bigdl_tpu_torch.dataset.ingest_pool import IngestPool, IngestWorkerDied
from bigdl_tpu_torch.dataset.loaders import (load_cifar10, load_mnist,
                                             write_cifar10_batch, write_mnist)
from bigdl_tpu_torch.dataset.seqfile import (BGRImgToLocalSeqFile,
                                             LocalSeqFilePath,
                                             LocalSeqFileToBytes,
                                             SeqBytesToBGRImg)
from bigdl_tpu_torch.dataset.sharded import (ShardedDataSet, partition_range,
                                             worker_shard)
from bigdl_tpu_torch.dataset.staging import StagingRing
from bigdl_tpu_torch.dataset.text import (Dictionary, LabeledSentence,
                                          LabeledSentenceToSample,
                                          LabeledSentenceToTokens,
                                          WordTokenizer, load_in_data,
                                          read_sentence, shaping, to_tokens,
                                          vectorization)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 Identity, Lambda, MiniBatch,
                                                 Sample, SampleToBatch,
                                                 Transformer, normalizer)

__all__ = ["AbstractDataSet", "BGRImgCropper", "BGRImgNormalizer",
           "BGRImgPixelNormalizer", "BGRImgRdmCropper", "BGRImgToBatch",
           "BGRImgToImageVector", "BGRImgToLocalSeqFile", "ByteRecord",
           "BytesToBGRImg", "BytesToGreyImg", "ChainedTransformer",
           "ColorJitter", "DataSet", "Dictionary",
           "GreyImgCropper", "GreyImgNormalizer", "GreyImgToBatch", "HFlip",
           "Identity", "IngestPool", "IngestWorkerDied", "LabeledBGRImage", "LabeledGreyImage", "LabeledImage",
           "LabeledSentence", "LabeledSentenceToSample",
           "LabeledSentenceToTokens", "Lambda", "Lighting",
           "LocalArrayDataSet", "LocalImgReader", "LocalSeqFilePath",
           "LocalSeqFileToBytes", "MiniBatch", "Sample", "SampleToBatch",
           "SeqBytesToBGRImg", "ShardedDataSet", "StagingRing",
           "TransformedDataSet", "Transformer",
           "WordTokenizer", "image_folder_paths", "load_cifar10",
           "load_in_data", "load_mnist", "normalizer", "partition_range",
           "read_sentence", "shaping", "to_tokens", "vectorization",
           "worker_shard", "write_cifar10_batch", "write_mnist"]
