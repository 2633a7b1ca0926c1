"""LeNet and MLP symbol builders.

Counterpart of ``mxnet_tpu/models/lenet.py`` (the reference's
example/image-classification/symbols/lenet.py and mlp.py): the same
graphs with the same node and parameter names, so both packages build
identical symbol JSON and checkpoints interchange.
"""
from .. import symbol as sym


def get_lenet(num_classes=10):
    """LeNet for 28x28 NCHW inputs: conv 5x5 x20, tanh, max-pool 2x2,
    conv 5x5 x50, tanh, max-pool 2x2, fc 500, tanh, fc ``num_classes``,
    softmax."""
    data = sym.Variable("data")
    conv1 = sym.Convolution(data, kernel=(5, 5), num_filter=20, name="conv1")
    tanh1 = sym.Activation(conv1, act_type="tanh")
    pool1 = sym.Pooling(tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    conv2 = sym.Convolution(pool1, kernel=(5, 5), num_filter=50, name="conv2")
    tanh2 = sym.Activation(conv2, act_type="tanh")
    pool2 = sym.Pooling(tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    flatten = sym.Flatten(pool2)
    fc1 = sym.FullyConnected(flatten, num_hidden=500, name="fc1")
    tanh3 = sym.Activation(fc1, act_type="tanh")
    fc2 = sym.FullyConnected(tanh3, num_hidden=num_classes, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def get_mlp(num_classes=10):
    """A three-layer perceptron: fc 128, relu, fc 64, relu, fc
    ``num_classes``, softmax."""
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = sym.Activation(fc1, name="relu1", act_type="relu")
    fc2 = sym.FullyConnected(act1, name="fc2", num_hidden=64)
    act2 = sym.Activation(fc2, name="relu2", act_type="relu")
    fc3 = sym.FullyConnected(act2, name="fc3", num_hidden=num_classes)
    return sym.SoftmaxOutput(fc3, name="softmax")
