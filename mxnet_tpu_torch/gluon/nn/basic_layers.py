"""Basic Gluon layers (counterpart of ``mxnet_tpu/gluon/nn/
basic_layers.py``): Sequential, HybridSequential, Dense, Activation,
Dropout, BatchNorm, LeakyReLU, Embedding, Flatten, Lambda, HybridLambda
and InstanceNorm, each over the registry's op of the same name."""
from __future__ import annotations

from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "LeakyReLU", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "InstanceNorm"]


class Sequential(Block):
    """Stack Blocks sequentially."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children:
            x = block(x)
        return x

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join(["  ({key}): {block}".format(
            key=key, block=repr(block).replace("\n", "\n  "))
            for key, block in enumerate(self._children)])
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)


class HybridSequential(HybridBlock):
    """Stack HybridBlocks sequentially."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children:
            x = block(x)
        return x

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join(["  ({key}): {block}".format(
            key=key, block=repr(block).replace("\n", "\n  "))
            for key, block in enumerate(self._children)])
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)


class Dense(HybridBlock):
    """Fully-connected layer: out = act(dot(x, w.T) + b)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            act = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        else:
            act = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        s = "{name}({layout}, {act})"
        shape = self.weight.shape
        return s.format(name=self.__class__.__name__,
                        act=self.act if self.act else "linear",
                        layout="{0} -> {1}".format(
                            shape[1] if shape[1] else None, shape[0]))


class Activation(HybridBlock):
    """Activation layer (relu/sigmoid/tanh/softrelu/softsign)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")

    def __repr__(self):
        return "{name}({_act_type})".format(name=self.__class__.__name__,
                                            **self.__dict__)


class Dropout(HybridBlock):
    """Dropout: the mask is drawn from the explicit generator of the
    input's device (``random.generator``)."""

    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, name="fwd")

    def __repr__(self):
        return "{name}(p = {_rate})".format(name=self.__class__.__name__,
                                            **self.__dict__)


class BatchNorm(HybridBlock):
    """Batch normalization: batch statistics in training, the running
    ones otherwise, which each training call updates in place."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        if in_channels != 0:
            self.in_channels = in_channels
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True,
                                    differentiable=center)
        self.running_mean = self.params.get("running_mean", grad_req="null",
                                            shape=(in_channels,),
                                            init=running_mean_initializer,
                                            allow_deferred_init=True,
                                            differentiable=False)
        self.running_var = self.params.get("running_var", grad_req="null",
                                           shape=(in_channels,),
                                           init=running_variance_initializer,
                                           allow_deferred_init=True,
                                           differentiable=False)

    def cast(self, dtype):
        if str(dtype).replace("torch.", "") == "float16":
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)

    def __repr__(self):
        s = "{name}({content}"
        in_channels = self.gamma.shape[0]
        s += ", in_channels={0}".format(in_channels if in_channels else None)
        s += ")"
        return s.format(name=self.__class__.__name__,
                        content=", ".join(
                            ["=".join([k, v.__repr__()])
                             for k, v in self._kwargs.items()]))


class LeakyReLU(HybridBlock):
    """Leaky ReLU."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha, name="fwd")

    def __repr__(self):
        return "{name}({alpha})".format(name=self.__class__.__name__,
                                        alpha=self._alpha)


class Embedding(HybridBlock):
    """Index -> dense vector lookup."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        self.weight = self.params.get("weight",
                                      shape=(input_dim, output_dim),
                                      init=weight_initializer,
                                      allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)

    def __repr__(self):
        s = "{block_name}({input_dim} -> {output_dim}, {dtype})"
        return s.format(block_name=self.__class__.__name__, **self._kwargs)


class Flatten(HybridBlock):
    """Flatten to (batch, -1)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return self.__class__.__name__


class InstanceNorm(HybridBlock):
    """Instance normalization."""

    def __init__(self, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"eps": epsilon}
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, name="fwd", **self._kwargs)


class Lambda(Block):
    """Wrap a function (or mx.nd op name) as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as F
            if not hasattr(F, function):
                raise ValueError("Function name %s is not found in ndarray."
                                 % function)
            self._func_impl = getattr(F, function)
        elif callable(function):
            self._func_impl = function
        else:
            raise ValueError(
                "Unrecognized function in lambda: {} of type {}".format(
                    function, type(function)))
        self._func_name = getattr(self._func_impl, "__name__", "custom")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "{name}({function})".format(name=self.__class__.__name__,
                                           function=self._func_name)


class HybridLambda(HybridBlock):
    """Wrap a function f(F, x) as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray, symbol
            if not (hasattr(ndarray, function) and hasattr(symbol, function)):
                raise ValueError("Function name %s is not found in both "
                                 "ndarray and symbol." % function)
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")
        else:
            raise ValueError(
                "Unrecognized function in lambda: {} of type {}".format(
                    function, type(function)))

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "{name}({function})".format(name=self.__class__.__name__,
                                           function=self._func_name)
