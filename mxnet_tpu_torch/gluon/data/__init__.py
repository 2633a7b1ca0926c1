"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers and the DataLoader.  The vision datasets (MNIST, CIFAR) need
files the repo does not have and are not ported yet."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader
