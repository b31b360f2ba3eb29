"""Model builders of the port."""

from bigdl_tpu_torch.models.alexnet import AlexNet, AlexNet_OWT
from bigdl_tpu_torch.models.autoencoder import Autoencoder
from bigdl_tpu_torch.models.inception import (Inception_v1, Inception_v2,
                                              inception_module,
                                              inception_module_v2)
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import (ResNet, basic_block, bottleneck,
                                           cifar10_decay)
from bigdl_tpu_torch.models.rnn import SimpleRNN, TextClassifierRNN
from bigdl_tpu_torch.models.transformer import TransformerBlock, TransformerLM
from bigdl_tpu_torch.models.vgg import Vgg_16, Vgg_19, VggForCifar10

__all__ = ["AlexNet", "AlexNet_OWT", "Autoencoder", "Inception_v1",
           "Inception_v2", "LeNet5", "ResNet", "SimpleRNN",
           "TextClassifierRNN", "TransformerBlock", "TransformerLM",
           "VggForCifar10", "Vgg_16", "Vgg_19", "basic_block", "bottleneck",
           "cifar10_decay", "inception_module", "inception_module_v2"]
