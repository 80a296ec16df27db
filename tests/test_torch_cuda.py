"""CUDA kernels of draco_tpu_torch against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  This
file imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernel against its plain version in float64 on the same
inputs, max|diff| / max|ref| <= 1e-5 (float32 sums of the kernel); the
band-end zeros exactly.
"""

import numpy as np
import pytest
import torch

from draco_tpu_torch.ops import banded, cuda_kernels, regrid

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(got, ref):
    return ((got.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


@pytest.mark.parametrize("m,n,B,bw", [(300, 1000, 5, 9), (128, 64, 2, 0), (97, 130, 3, 31), (2, 77, 1, 4)])
def test_banded_covariance_kernel_matches_plain(cuda, m, n, B, bw):
    g = torch.Generator(device="cpu").manual_seed(m * n + bw)
    R = torch.randn(m, n, generator=g).to(cuda)
    Ni = torch.rand(B, n, generator=g).to(cuda)
    Ni[:, n // 3 : n // 3 + 5] = 0.0
    before = cuda_kernels.launches["banded_covariance"]
    out = cuda_kernels.banded_covariance_batched(R, Ni, bw)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["banded_covariance"] == before + 1
    ref = banded.banded_covariance(R.double(), Ni.double(), bw)
    assert out.shape == (B, bw + 1, m) and out.dtype == torch.float32
    assert _rel(out, ref) <= 1e-5
    for d in range(bw + 1):
        assert (out[:, d, max(m - d, 0) :] == 0).all()


def test_banded_covariance_kernel_rejects_what_it_does_not_take(cuda):
    R = torch.randn(40, 64, device=cuda)
    Ni = torch.rand(3, 64, device=cuda)
    with pytest.raises(TypeError):
        cuda_kernels.banded_covariance_batched(R.double(), Ni.double(), 3)
    with pytest.raises(ValueError):
        cuda_kernels.banded_covariance_batched(R.T.contiguous().T, Ni, 3)
    with pytest.raises(ValueError):
        cuda_kernels.banded_covariance_batched(R, Ni, 32)
    with pytest.raises(ValueError):
        cuda_kernels.banded_covariance_batched(R, Ni.cpu(), 3)


def test_band_wiener_on_the_card_matches_the_cpu(cuda):
    rng = np.random.Generator(np.random.SFC64(4))
    m, n, k, bw = 120, 500, 4, 9
    grid = np.linspace(0, 1, m)
    R = regrid.lanczos_forward_matrix(grid, np.sort(rng.uniform(0, 1, n)), a=5).T
    R = torch.as_tensor(R, dtype=torch.float64)
    Ni = torch.as_tensor(rng.uniform(0.5, 2.0, (k, n)))
    y = torch.as_tensor(rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n)))
    Si = torch.full((m,), 1e-1, dtype=torch.float64)
    xh, nw = regrid.band_wiener(R, Ni, Si, y, bw)
    before = cuda_kernels.launches["banded_covariance"]
    xg, ng = regrid.band_wiener(
        R.float().to(cuda), Ni.float().to(cuda), Si.float().to(cuda), y.to(torch.complex64).to(cuda), bw
    )
    assert cuda_kernels.launches["banded_covariance"] == before + 1
    assert _rel(ng.cpu(), nw) <= 1e-5
    # the float32 banded solve against the float64 one on the CPU
    assert _rel(torch.view_as_real(xg.cpu()), torch.view_as_real(xh)) <= 1e-5
