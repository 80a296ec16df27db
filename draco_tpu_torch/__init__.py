"""draco_tpu_torch: the PyTorch/CUDA port of draco_tpu for NVIDIA Hopper.

The JAX package ``draco_tpu`` is the reference this port is held
against.  Modules mirror its layout.  Plain tensor code is PyTorch; the
one TPU kernel of the JAX package (the banded-covariance build of the
sidereal regridder) is a CUDA kernel written for ``sm_90a``
(``csrc/banded_covariance.cu``), and so are two XLA programs of its hot
paths (``csrc/beamform.cu``, ``csrc/legendre.cu``), each built on first
use by ``_build``.

Functions follow the device of their input tensors or take ``device=``;
nothing picks a device implicitly.  Randomness is passed in explicitly.
"""

__version__ = "0.1.0"

import torch as _torch

# The 1e-5 end-to-end map-error contract does not survive TF32 (about
# three decimal digits): every float32 product runs in full float32, the
# policy draco_tpu pins with Precision.HIGHEST.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
