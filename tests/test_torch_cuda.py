"""On-card checks of the CUDA decode kernels against their plain twins.

Marked ``cuda``: without a card every test skips (a CUDA kernel has no
CPU mode). On a machine with one, from the repo root:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures jax, which that
machine does not have; this file imports only torch and the port.)

Tolerance rtol = atol = 1e-4: f32 operands and accumulation on both
sides; the kernel sums in another order than cuBLAS and blends before
the head in its own order.
"""

import numpy as np
import pytest
import torch

from space_time_pde_torch.models import ImNet
from space_time_pde_torch.models.nonlinearities import NONLINEARITIES
from space_time_pde_torch.ops import _build
from space_time_pde_torch.ops import fused_query as fq

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, nf, c, dim, n, activation, seed=0):
    torch.manual_seed(seed)
    imnet = ImNet(dim=dim, in_features=c, out_features=4, nf=nf,
                  activation=activation).to(device)
    rng = np.random.RandomState(seed)
    spatial = (5, 6, 7, 4)[:dim]
    grid = torch.from_numpy(rng.randn(*spatial, c).astype(np.float32))
    table = fq.cell_major_features(grid).contiguous().to(device)
    n_cells = table.shape[0]
    cell_flat = torch.from_numpy(
        rng.randint(0, n_cells, n).astype(np.int32)).to(device)
    frac = rng.rand(n, dim).astype(np.float32)
    frac[: min(n, 4)] = np.array([0.0, 1.0, 0.5, 1.0])[: min(n, 4), None]
    frac = torch.from_numpy(frac).to(device)
    return fq.pack_imnet_params(imnet), table, cell_flat, frac


def test_kernels_build(device):
    _build.load()
    log = _build.build_log()
    print(f"nvcc {log.get('seconds', 0.0):.1f}s\n{log.get('ptxas', '')}")


CASES = ([(4, 8, 3, 257, a) for a in NONLINEARITIES]
         + [(8, 8, 2, 100, "leaky_relu"), (2, 4, 4, 33, "elu"),
            (64, 64, 3, 4096, "leaky_relu"), (64, 64, 3, 4096, "gelu")])


@pytest.mark.parametrize("nf,c,dim,n,activation", CASES)
def test_kernels_match_plain(device, nf, c, dim, n, activation):
    packed, table, cell_flat, frac = _inputs(device, nf, c, dim, n,
                                             activation)
    kw = dict(nf=nf, activation=activation, negative_slope=0.01)
    want = fq.decode_blend_gather_plain(table, cell_flat, frac, packed, **kw)
    fq.reset_launches()
    got = fq.decode_blend_gather(table, cell_flat, frac, packed, **kw)
    feats2 = table[cell_flat.long()].reshape(-1, c).contiguous()
    got2 = fq.decode_blend(feats2, frac, packed, n_corners=2 ** dim, **kw)
    torch.cuda.synchronize()
    assert fq.LAUNCHES == {"decode_blend_gather": 1, "decode_blend": 1}
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    np.testing.assert_allclose(got2.cpu().numpy(), want.cpu().numpy(), **TOL)


def test_out_of_range_cell_decodes_nan(device):
    packed, table, cell_flat, frac = _inputs(device, 4, 8, 3, 16,
                                             "leaky_relu")
    cell_flat[3] = table.shape[0]
    got = fq.decode_blend_gather(table, cell_flat, frac, packed, nf=4)
    torch.cuda.synchronize()
    bad = torch.isnan(got).any(dim=1).cpu().numpy()
    assert bad[3] and bad.sum() == 1


def test_shared_memory_overflow_raises(device):
    """The kernel sizes its shared memory; nf = 128 needs ~390 KB a
    block, more than the card has, and the launch's error is raised."""
    packed, table, cell_flat, frac = _inputs(device, 128, 8, 3, 16,
                                             "leaky_relu")
    assert fq.block_points(3, device) == _build.load().stpde_block_rows() // 8
    with pytest.raises(RuntimeError, match="CUDA error"):
        fq.decode_blend_gather(table, cell_flat, frac, packed, nf=128)
