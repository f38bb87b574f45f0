"""The SPD kernel's build cache key, its wrapper's refusals on the CPU and
the measuring helpers of ``srba_tpu_torch/tools/spd_inverse_bench.py``
(the kernel itself runs only on a card: tests/test_torch_cuda.py)."""

import hashlib
import shutil

import numpy as np
import pytest
import torch

from srba_tpu_torch.ops import block_linalg as bl
from srba_tpu_torch.tools import spd_inverse_bench as kb


def test_build_cache_key_covers_every_source(tmp_path):
    """A header added to csrc/, or changed, changes the key (so a stale
    library is never loaded); a file the build does not read does not."""
    assert [p.name for p in bl.kernel_sources()] == ["spd_inverse.cu"]
    src = tmp_path / "csrc"
    shutil.copytree(bl._CSRC_DIR, src)
    base = bl.source_digest(src)
    assert base == bl.source_digest()
    (src / "notes.txt").write_text("not a source")
    assert bl.source_digest(src) == base
    (src / "tile.cuh").write_text("#pragma once\n")
    with_header = bl.source_digest(src)
    assert with_header != base
    (src / "tile.cuh").write_text("#pragma once\n// changed\n")
    assert bl.source_digest(src) not in (base, with_header)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("with_out", [False, True])
def test_kernel_wrapper_refuses_cpu_tensors(d, with_out):
    m = torch.eye(d).repeat(4, 1, 1)
    out = torch.empty_like(m) if with_out else None
    with pytest.raises(ValueError, match="CUDA tensor"):
        bl.spd_inverse_cuda(m, out)


@pytest.mark.parametrize("B, d", kb.SHAPES)
def test_bound_is_bytes_over_hbm_rate(B, d):
    """Each input block read once and each output block written once, at
    3.35 TB/s."""
    assert kb.bound_us(B, d) == pytest.approx(
        (B * d * d * 4 + B * d * d * 4) / 3.35e12 * 1e6)


def test_bound_at_the_pgo_stacks():
    assert kb.bound_us(131072, 6) == pytest.approx(11.268, abs=1e-3)
    assert kb.bound_us(32768, 6) == pytest.approx(2.817, abs=1e-3)


@pytest.mark.parametrize("B, d", kb.SHAPES)
def test_cold_rotation_spans_twice_l2(B, d):
    """A cold run's stacks span more than twice the 50 MB L2, or there is
    one per launch when stacks are small."""
    n = kb.cold_stacks(B, d, iters=200)
    assert 2 <= n <= 200
    assert n == 200 or n * 2 * B * d * d * 4 > 2 * kb.L2_BYTES


def test_ptxas_summary_reads_each_kernel():
    report = (
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__6d58b53c"
        "_14_spd_inverse_cu_f5de9e2518spd_inverse_stagedILi6ELb1EEEvPKfPfx' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN...\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 44 registers, used 1 barriers, 9216 bytes "
        "smem, 380 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__6d58b53c"
        "_14_spd_inverse_cu_f5de9e2514spd_inverse_d1ILb0EEEvPKfPfx' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 16 registers, used 0 barriers, 380 bytes "
        "cmem[0]\n")
    assert kb.ptxas_summary(report) == [
        ("spd_inverse_staged<6,1>", 44, 9216, 8, 4),
        ("spd_inverse_d1<0>", 16, 0, 0, 0)]


def test_output_digest_is_sha256_of_the_bytes():
    x = torch.as_tensor(kb.spd_stack(5, 3))
    assert kb.output_digest(x) == hashlib.sha256(
        x.numpy().tobytes()).hexdigest()
    y = x.clone()
    y.view(-1)[7] = torch.nextafter(y.view(-1)[7], torch.tensor(np.inf))
    assert kb.output_digest(y) != kb.output_digest(x)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_spd_stack_is_symmetric_positive_definite(d):
    m = kb.spd_stack(16, d, seed=d)
    np.testing.assert_allclose(m, m.transpose(0, 2, 1), rtol=1e-6)
    assert (np.linalg.eigvalsh(m.astype(np.float64)) > 4.9).all()
