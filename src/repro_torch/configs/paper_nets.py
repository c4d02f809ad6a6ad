"""The paper's own networks -- Table 1 of Vishnu et al. 2016 (own copy
of ``repro.configs.paper_nets``).

| Data set | Algo | Network Architecture        |
|----------|------|-----------------------------|
| Adult    | DNN  | 123-200-100-2               |
| Acoustic | DNN  | 50-200-100-3                |
| MNIST    | DNN  | 784-200-100-10              |
| MNIST    | CNN  | 32,64 (CONV), 1024 (FULL)   |
| CIFAR10  | DNN  | 3072-200-100-10             |
| CIFAR10  | CNN  | 32,64 (CONV), 1024 (FULL)   |
| HIGGS    | DNN  | 28-1024-2                   |

CNNs: 5x5 conv windows, stride 1, ReLU, each followed by 2x2 max-pool;
then sigmoid fully-connected layer(s), then softmax output (paper §4.1).
"""
from repro_torch.configs.base import PaperNetConfig

ADULT_DNN = PaperNetConfig(
    name="adult-dnn", kind="dnn", layer_sizes=(123, 200, 100, 2),
    dataset="adult")
ACOUSTIC_DNN = PaperNetConfig(
    name="acoustic-dnn", kind="dnn", layer_sizes=(50, 200, 100, 3),
    dataset="acoustic")
MNIST_DNN = PaperNetConfig(
    name="mnist-dnn", kind="dnn", layer_sizes=(784, 200, 100, 10),
    dataset="mnist")
MNIST_CNN = PaperNetConfig(
    name="mnist-cnn", kind="cnn", image_hw=(28, 28), image_channels=1,
    conv_channels=(32, 64), fc_size=1024, num_classes=10, dataset="mnist")
CIFAR10_DNN = PaperNetConfig(
    name="cifar10-dnn", kind="dnn", layer_sizes=(3072, 200, 100, 10),
    dataset="cifar10")
CIFAR10_CNN = PaperNetConfig(
    name="cifar10-cnn", kind="cnn", image_hw=(32, 32), image_channels=3,
    conv_channels=(32, 64), fc_size=1024, num_classes=10, dataset="cifar10")
HIGGS_DNN = PaperNetConfig(
    name="higgs-dnn", kind="dnn", layer_sizes=(28, 1024, 2),
    dataset="higgs")

PAPER_NETS = {c.name: c for c in (
    ADULT_DNN, ACOUSTIC_DNN, MNIST_DNN, MNIST_CNN,
    CIFAR10_DNN, CIFAR10_CNN, HIGGS_DNN)}
