"""The model zoo's ResNet-18 v1 in the PyTorch port against the JAX
package's: the check of test_torch_gluon_resnet.py (2 hybridized Trainer
steps from the same weights; step 1's loss to 1e-5 relative; step 2's
loss, step 1's gradients and the parameters and moving statistics after
step 2 within 3x the JAX package's batch-reversed control, whose values
that file's docstring gives; the port's hybridized net equal to its
imperative one bit for bit)."""
import torch

from test_torch_gluon_resnet import check_family

torch.set_num_threads(1)


def test_resnet18_v1_against_jax(tmp_path):
    check_family("resnet18_v1", tmp_path)
