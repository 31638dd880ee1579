"""The attention kernels' width contract, their build's cache key, and the
bounds ``chip_smoke.py`` reports, on the CPU.

The kernels pad each head width to 32, 64 or 128 and keep one compiled
instance per padded (dk, dv) pair; a pair with a width past 128 pads both to
256 and takes the one (256, 256) instance. So the wrappers take any
dk, dv <= 256 and refuse wider heads before any launch. Fake CUDA tensors
stand in for real ones.
"""

import re
import shutil

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke
from ieagan_torch.kernels import build
from ieagan_torch.kernels import flash_attention as fa
from ieagan_torch.kernels import selfcheck

# (dk, dv) at the model's sites and in the JAX self-check (D_ch 16)
MODEL_WIDTHS = [(64, 64), (128, 128), (32, 128), (16, 64), (256, 256)]


def _header_instances():
    text = (build.CSRC_DIR / "mma_tile.cuh").read_text()
    macro = re.search(r"#define IEAGAN_ATTENTION_WIDTHS\(X\)(.*?)\n\n", text, re.S).group(1)
    return {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}


@pytest.mark.parametrize("d,want", [(1, 32), (5, 32), (16, 32), (32, 32), (33, 64), (64, 64),
                                    (65, 128), (100, 128), (128, 128), (129, 256), (256, 256)])
def test_padded_width(d, want):
    assert fa.padded_width(d) == want


@pytest.mark.parametrize("dk,dv,want", [(32, 128, (32, 128)), (129, 8, (256, 256)),
                                        (64, 256, (256, 256)), (256, 256, (256, 256))])
def test_padded_pair(dk, dv, want):
    """A pair with a width past 128 takes the (256, 256) instance."""
    assert fa.padded_pair(dk, dv) == want


def test_widths_past_128_are_refused():
    """Since the 256 instance, the refusal starts past 256."""
    with pytest.raises(ValueError, match="dk, dv <= 256"):
        fa.padded_width(257)


def test_every_padded_pair_is_built():
    """The CUDA sources instantiate every pair of padded widths up to 128 and
    the one (256, 256) pair, so every dk, dv <= 256 the wrappers let through
    has a kernel, the model's widths among them."""
    instances = _header_instances()
    narrow = [w for w in fa.PADDED_WIDTHS if w <= 128]
    assert instances == {(a, b) for a in narrow for b in narrow} | {(256, 256)}
    for dk, dv in MODEL_WIDTHS + [case[4:6] for case in selfcheck.CASES]:
        assert fa.padded_pair(dk, dv) in instances


@pytest.fixture
def no_nvcc(monkeypatch):
    """A CUDA toolchain that is not there: reaching the build raises."""
    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "nvcc_path", missing)
    monkeypatch.setattr(fa, "_LIB", None)
    monkeypatch.setattr(fa, "_LIB_BWD", None)


@pytest.mark.parametrize("dk,dv", [(5, 7), (100, 48), (16, 64), (32, 128), (256, 256), (200, 64)])
def test_padded_widths_reach_the_kernels(no_nvcc, dk, dv):
    """Odd widths pass the width check and go on to the kernels' build."""
    with FakeTensorMode():
        q, k = torch.empty(2, 40, dk, device="cuda"), torch.empty(2, 24, dk, device="cuda")
        v, o = torch.empty(2, 24, dv, device="cuda"), torch.empty(2, 40, dv, device="cuda")
        lse = torch.empty(2, 40, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            fa.attention_fwd(q, k, v, 0.5)
        with pytest.raises(RuntimeError, match="nvcc"):
            fa.attention_bwd(q, k, v, o, lse, o, 0.5)


@pytest.mark.parametrize("dk,dv", [(257, 64), (64, 257), (512, 512)])
def test_widths_past_128_are_refused_before_launch(no_nvcc, dk, dv):
    """Heads wider than 256 (since the 256 instance; 128 before it) are
    refused by both wrappers before any build or launch, naming the
    widths."""
    before = (fa.attention_fwd.launches, fa.attention_bwd.launches)
    with FakeTensorMode():
        q, v = torch.empty(2, 40, dk, device="cuda"), torch.empty(2, 40, dv, device="cuda")
        lse = torch.empty(2, 40, device="cuda")
        message = rf"dk, dv <= 256; got dk={dk}, dv={dv}"
        with pytest.raises(ValueError, match=message):
            fa.attention_fwd(q, q, v, 1.0)
        with pytest.raises(ValueError, match=message):
            fa.attention_bwd(q, q, v, v, lse, v, 1.0)
    assert (fa.attention_fwd.launches, fa.attention_bwd.launches) == before


def test_the_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """Both sources include csrc/mma_tile.cuh: editing it must give new
    library names, or a stale build would be loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {name: build.library_path(name) for name in build.sources()}
    (csrc / "mma_tile.cuh").write_text((csrc / "mma_tile.cuh").read_text() + "\n// edit\n")
    after = {name: build.library_path(name) for name in build.sources()}
    assert set(before) == {"attention_fwd", "attention_bwd"}
    assert all(before[name] != after[name] for name in before)


@pytest.mark.parametrize("work,dtype,bound,simt", [
    (chip_smoke.fwd_work, "float32", 0.1830, 0.4507),
    (chip_smoke.bwd_work, "float32", 0.4027, 0.9916),
    (chip_smoke.fwd_work, "bfloat16", 0.03053, None),
    (chip_smoke.bwd_work, "bfloat16", 0.06717, None),
])
def test_chip_smoke_bounds_at_the_image_attention_site(work, dtype, bound, simt):
    """D_SA at 40 images: f32 bounded by split-TF32 (495/3 TFLOP/s) with the
    SIMT pipe's bound beside it, bf16 by the bf16 tensor cores; achieved
    TFLOP/s from the row's time."""
    itemsize = 4 if dtype == "float32" else 2
    nbytes, flops = work(40, 3072, 768, 32, 128, itemsize)
    row = {"ms": 2.0}
    chip_smoke.add_bound(row, nbytes, flops, dtype)
    assert row["bound_by"] == "operations"
    assert row["bound_ms"] == pytest.approx(bound, rel=1e-3)
    assert row.get("simt_bound_ms") == (None if simt is None else pytest.approx(simt, rel=1e-3))
    assert row["tflops"] == pytest.approx(flops / 2e-3 / 1e12)


def test_chip_smoke_reads_the_ptxas_report():
    """One line per kernel (registers, stack, spills) and per device function
    compiled on its own (stack, spills), named by kernel, type and widths."""
    log = """ptxas info    : Function properties for _ZN49_GLOBAL__N__74ff_16_attention_bwd_cu_9dcb5feb10dkdv_blockIfLi32ELi128EEEvPh
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__74ff_16_attention_bwd_cu_9dcb5feb10bwd_kernelI13__nv_bfloat16Li64ELi64EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__74ff_16_attention_bwd_cu_9dcb5feb10bwd_kernelI13__nv_bfloat16Li64ELi64EEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 197 registers, used 1 barriers, 24 bytes cumulative stack size
"""
    assert chip_smoke.ptxas_summary(log) == [
        "dkdv_block f32 32x128: stack 24 B, spills 8/12 B",
        "bwd_kernel bf16 64x64: 197 registers, stack 0 B, spills 0/0 B"]
