"""Declarative layer-table assembler for the vision model zoo
(counterpart of ``mxnet_tpu/gluon/model_zoo/vision/_builder.py``).

Architectures in this package are DATA: tuples naming a layer kind plus
its hyperparameters, consumed by this one generic assembler.  A single
place constructs layers; the per-model files only declare tables.

Row mini-language — trailing dict = keyword overrides:
    ("conv", channels, kernel, stride, pad[, {...}])
    ("bn"[, {...}])        ("relu",)
    ("pool", size, stride, pad)
    ("gap",)               ("flatten",)
    ("dense", units[, {...}])
    ("dropout", rate)

Only parameterized layers (conv/bn/dense) influence parameter naming, so
tables stay checkpoint-compatible as long as those appear in the same
order inside the same name scopes as before.
"""
from ... import nn


def _conv(channels, kernel=1, stride=1, pad=0, groups=1, bias=True,
          act=None, init=None):
    kw = {"groups": groups, "use_bias": bias}
    if act is not None:
        kw["activation"] = act
    if init is not None:
        kw["weight_initializer"] = init
        kw["bias_initializer"] = "zeros"
    return nn.Conv2D(channels, kernel, stride, pad, **kw)


def _dense(units, act=None, init=None):
    kw = {}
    if init is not None:
        kw["weight_initializer"] = init
        kw["bias_initializer"] = "zeros"
    return nn.Dense(units, activation=act, **kw)


_MAKERS = {
    "conv": _conv,
    "bn": lambda **kw: nn.BatchNorm(**kw),
    "relu": lambda: nn.Activation("relu"),
    "pool": lambda size=3, stride=2, pad=0: nn.MaxPool2D(size, stride, pad),
    "gap": lambda: nn.GlobalAvgPool2D(),
    "flatten": lambda: nn.Flatten(),
    "dense": _dense,
    "dropout": lambda rate=0.5: nn.Dropout(rate),
}


def make_layer(row):
    """Instantiate one declared row."""
    kind = row[0]
    args, kw = [], {}
    for a in row[1:]:
        if isinstance(a, dict):
            kw.update(a)
        else:
            args.append(a)
    return _MAKERS[kind](*args, **kw)


def assemble(seq, rows):
    """Append every declared row to a (Hybrid)Sequential; returns it."""
    for row in rows:
        seq.add(make_layer(row))
    return seq


def named_factory(name, fn, *preset_args, **preset_kw):
    """A zoo constructor: calls ``fn(*preset_args, **kwargs-merged)`` and
    carries a proper __name__ (resnet18_v1, vgg16_bn, ...)."""
    def ctor(**kwargs):
        merged = dict(preset_kw)
        merged.update(kwargs)
        return fn(*preset_args, **merged)
    ctor.__name__ = ctor.__qualname__ = name
    return ctor
