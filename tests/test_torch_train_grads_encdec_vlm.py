"""The port's ``loss_fn`` and every param leaf's gradient held against
the reference's on the CPU: the encdec and vlm families' SMOKE configs
(whisper's random frames, InternVL2's random patches).

How they are held, and the bounds: ``tests/_torch_grads.py``.
"""
import pytest

from _torch_grads import (  # noqa: F401
    cases, check_loss_and_grads, one_torch_thread)


@pytest.mark.parametrize("arch,dtype", cases([
    "whisper_small",
    "internvl2_26b",
]))
def test_loss_and_grads_match_reference(arch, dtype, monkeypatch):
    check_loss_and_grads(arch, dtype, monkeypatch)
