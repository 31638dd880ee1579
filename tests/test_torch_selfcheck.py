"""``ieagan_torch.kernels.selfcheck`` on the CPU: its error arithmetic, its
refusal without a card, and one case run through the kernels' plain versions
(what ``FlashAttention`` computes for CPU tensors)."""

import numpy as np
import pytest
import torch

from ieagan_torch.kernels import selfcheck

TINY_CASE = ("tiny", 2, 40, 24, 16, 32, 0.25)


def test_normalized_errors_are_frobenius_relative_and_max_over_std():
    want = torch.tensor([1.0, 2.0, 3.0, 4.0])
    got = want + torch.tensor([0.0, 0.0, 0.0, 0.4])
    fro, max_over_std = selfcheck.normalized_errors(got, want)
    w = want.numpy().astype(np.float64)
    assert fro == pytest.approx(0.4 / np.linalg.norm(w))
    assert max_over_std == pytest.approx(0.4 / np.std(w))  # population std, as np.std
    assert selfcheck.normalized_errors(want, want) == (0.0, 0.0)


def test_run_check_refuses_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfcheck.run_check(torch.float32)


def test_cases_are_the_model_sites_and_the_jax_selfcheck_shape():
    """The sites include D's proxy RRM (head width 256, at the concat mode's
    sequence of 80) since the kernels' 256 instance."""
    widths = {case[4:6] for case in selfcheck.CASES}
    assert widths == {(64, 64), (128, 128), (32, 128), (16, 64), (256, 256)}
    assert {case[2:4] for case in selfcheck.CASES} == {(40, 40), (3072, 768), (80, 80)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_case_through_the_plain_versions_passes(dtype):
    """On the CPU FlashAttention runs the kernels' plain versions: against
    the plain composition they differ by rounding only, far inside the
    bounds (f32 to 1e-6; bf16 by the composition's bf16 product)."""
    worst = selfcheck.check_case(TINY_CASE, dtype, "cpu")
    assert worst < (1e-6 if dtype == torch.float32 else selfcheck.BOUNDS[dtype][0] / 2)


def test_a_masking_fault_is_caught(monkeypatch):
    """An attention that drops the last kv row -- the kind of fault the
    check exists for -- fails it."""
    class DropsLastRow:
        @staticmethod
        def apply(q, k, v, scale):
            return selfcheck.dot_softmax_attention(q, k[:, :-1], v[:, :-1], scale=scale)

    monkeypatch.setattr(selfcheck, "FlashAttention", DropsLastRow)
    with pytest.raises(AssertionError, match="tiny/out"):
        selfcheck.check_case(TINY_CASE, torch.float32, "cpu")
