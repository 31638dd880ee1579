"""BigGAN-deep 256 on the port's generation path, on the CPU in float32:
``sample_batched`` through ``Model`` and ``Generator.from_config`` against
the plain reference ``references/biggan_deep.py`` on the 256 table at a
small width (every layer kind of the published configuration: the shared
embedding with ``hier``, bottleneck GBlocks with ccbn, SN, SA at 64x64, the
output BN and the RGB conv); the draw replayed from the generator's state;
B1's instance for SA over 512 channels, (64, 256), which B2 does not take,
and the instance each launch passes to its kernel; the benchmark's copy of
the reference."""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from benchmark.harness import weights
from ieagan_torch.core.config import DEFAULT_CONFIG
from ieagan_torch.deploy.inference import Model, sample_batched
from ieagan_torch.kernels import build
from ieagan_torch.kernels import flash_attention as fa
from references import biggan_deep as ref
from tests.test_torch_eval import few_torch_threads  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parents[1]
# the published configuration's options (BigGANdeep.py's G_arch[256];
# chip_smoke.py's BIGGAN_DEEP_256) at G_ch 8 and 10 classes
CFG = dict(DEFAULT_CONFIG, resolution=256, G_ch=8, G_depth=2, H_base=1, G_attn="64",
           n_classes=10, output_channels=3, RRM_prx_G=False, rdof_dim=0, hier=True,
           shared_dim=128, dim_z=128, BN_eps=1e-5, SN_eps=1e-6, use_pallas_attention=True)
IMAGES = 4


def _model(seed=5):
    S = weights.make(ref.g_spec(CFG), seed, "cpu")
    model = Model(config=CFG, device="cpu", _random_init=False)
    model.G.load_state_dict(S, strict=True)
    return model, S


def test_sample_batched_matches_the_reference():
    """The port against the reference from the same state, latents and
    labels. Both compute in float32; the port folds each batch norm into one
    multiply-add and sums its products in other orders, which moves a
    [-1, 1] output by ~2e-6 at most over the 13 layers; 2e-5 leaves ten
    times that, and a bf16 product anywhere (~4e-3 of the output) fails."""
    model, S = _model()
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    out = sample_batched(model, IMAGES, gen)
    assert out.shape == (IMAGES, 256, 256, 3) and out.dtype == torch.float32
    assert out.device.type == "cpu"
    assert -1.0 <= float(out.min()) and float(out.max()) <= 1.0
    assert float(out.std()) > 0.1        # not saturated: the comparison sees the values
    replay = torch.Generator()
    replay.set_state(state)
    want = ref.generator(CFG, S, *model.draw_images(IMAGES, replay))
    assert float((out - want).abs().max()) <= 2e-5
    assert model.G.attn_3.ch == 4 * CFG["G_ch"]      # SA at 64x64, as at 512 channels


def test_the_draw_replays_from_the_generator_state():
    """z (standard normal, ``dim_z``), then the labels (uniform over the
    classes), from the call's generator and nothing else."""
    model, _ = _model()
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    z, y = model.draw_images(500, gen)
    after = gen.get_state()
    replay = torch.Generator()
    replay.set_state(state)
    assert torch.equal(z, torch.randn((500, CFG["dim_z"]), generator=replay))
    assert torch.equal(y, torch.randint(0, CFG["n_classes"], (500,), generator=replay))
    assert torch.equal(replay.get_state(), after)
    assert y.dtype == torch.int64 and set(y.tolist()) == set(range(CFG["n_classes"]))
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05


def _cases(source):
    """The (padded dk, padded dv) instances a kernel's dispatch launches:
    the shared table's and its own literal cases."""
    text = (build.CSRC_DIR / source).read_text()
    body = text[text.index("IEAGAN_ATTENTION_WIDTHS(IEAGAN_CASE)"):text.index("#undef IEAGAN_CASE")]
    own = {(int(a), int(b)) for a, b in re.findall(r"IEAGAN_CASE\((\d+), (\d+)\)", body)}
    header = (build.CSRC_DIR / "mma_tile.cuh").read_text()
    macro = re.search(r"#define IEAGAN_ATTENTION_WIDTHS\(X\)(.*?)\n\n", header, re.S).group(1)
    return {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}, own


def test_b1_takes_the_64_by_256_instance_and_b2_does_not():
    shared, fwd_own = _cases("attention_fwd.cu")
    _, bwd_own = _cases("attention_bwd.cu")
    assert fwd_own == {(64, 256)} and bwd_own == set()
    assert fa.fwd_pair(64, 256) == (64, 256)          # G SA over 512 channels
    assert fa.padded_pair(64, 256) == (256, 256)      # B2 keeps its instance
    for dk in range(1, 257):
        for dv in range(1, 257):
            got, b2 = fa.fwd_pair(dk, dv), fa.padded_pair(dk, dv)
            assert got in shared | fwd_own and b2 in shared
            assert got[0] >= dk and got[1] >= dv
            if dk <= 64 and 128 < dv:
                assert got == (64, 256), (dk, dv)
            else:
                assert got == b2, (dk, dv)


@pytest.mark.filterwarnings("ignore:Accessing the data pointer of FakeTensor")
@pytest.mark.parametrize("dk,dv,b1,b2", [(64, 256, (64, 256), (256, 256)),
                                         (32, 200, (64, 256), (256, 256)),
                                         (32, 128, (32, 128), (32, 128)),
                                         (128, 256, (256, 256), (256, 256)),
                                         (200, 130, (256, 256), (256, 256))])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_a_launch_passes_the_instance_it_takes(kernel, dk, dv, b1, b2, monkeypatch):
    """The kernels keep no pair rule: each launch passes (pk, pv) after
    (batch, lq, lkv, dk, dv), ``fwd_pair``'s to B1 and ``padded_pair``'s to
    B2 (fake CUDA tensors; a library that records its calls)."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    lib = SimpleNamespace(ieagan_attention_fwd=entry, ieagan_attention_bwd=entry)
    monkeypatch.setattr(fa, "_LIB", lib)
    monkeypatch.setattr(fa, "_LIB_BWD", lib)
    monkeypatch.setattr(fa.attention_fwd, "launches", 0)
    monkeypatch.setattr(fa.attention_bwd, "launches", 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=0))
    with FakeTensorMode():
        q, k = torch.empty(2, 40, dk, device="cuda"), torch.empty(2, 24, dk, device="cuda")
        v = torch.empty(2, 24, dv, device="cuda")
        if kernel == "fwd":
            fa.attention_fwd(q, k, v, 1.0)
        else:
            o, do = torch.empty(2, 40, dv, device="cuda"), torch.empty(2, 40, dv, device="cuda")
            fa.attention_bwd(q, k, v, o, torch.empty(2, 40, device="cuda"), do, 1.0)
    (args,) = calls
    n_ptrs = 5 if kernel == "fwd" else 10
    assert args[n_ptrs:n_ptrs + 7] == (2, 40, 24, dk, dv, *(b1 if kernel == "fwd" else b2))


def test_the_benchmark_copy_of_the_reference_is_the_reference():
    assert (ROOT / "benchmark" / "reference" / "biggan_deep.py").read_bytes() == \
        (ROOT / "references" / "biggan_deep.py").read_bytes()
