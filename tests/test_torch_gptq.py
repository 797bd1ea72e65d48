"""The port's GPTQ (Tables 3 and 5) against the JAX package's numpy GPTQ on
the CPU, torch float64: the dequantized weight must equal the reference's
exactly, under the RaZeR and INT4 group quantizers, at group 16 with block
32, group 128 with block 64 (each group crossing a block boundary) and with
one dead input channel.  The reference looks for dead channels after it
damps the Hessian, so with the default damping a dead channel is damped
like any other; with ``damp=0`` its Hessian diagonal is set to 1 and its
weights to zero, and the case checks both.
GPTQ also beats round-to-nearest on correlated inputs, as the reference
test asserts, and runs on the GPU unless asked for the CPU."""
import numpy as np
import pytest
import torch

from repro.core import gptq as jgptq
from repro.core.baselines import int4_quantize as jint4
from repro.core.razer import razer_quantize as jrazer
from repro_torch.core import gptq as tgptq
from repro_torch.core.baselines import int4_quantize as tint4
from repro_torch.core.razer import razer_quantize as trazer

torch.set_num_threads(2)


def _case(d_in=128, d_out=64, seed=7, dead=False):
    rng = np.random.default_rng(seed)
    w = (rng.standard_t(5, size=(d_in, d_out)) * 0.02).astype(np.float32)
    x = rng.standard_normal((512, d_in)).astype(np.float32)
    x[:, 1:] += 0.5 * x[:, :-1]  # correlated input channels
    if dead:
        x[:, 3] = 0.0
    return w, x


def _factories(fmt, group_size):
    if fmt == "razer":
        return (jgptq.make_group_quantizer(lambda g: jrazer(g, axis=0, scale_fmt="e3m3")),
                tgptq.make_group_quantizer(lambda g: trazer(g, axis=0, scale_fmt="e3m3")))
    return (jgptq.make_group_quantizer(lambda g: jint4(g, axis=0, block_size=group_size)),
            tgptq.make_group_quantizer(lambda g: tint4(g, axis=0, block_size=group_size)))


@pytest.mark.parametrize("dead,damp", [(False, 0.01), (True, 0.01), (True, 0.0)])
@pytest.mark.parametrize("group_size,block_size", [(16, 32), (128, 64)])
@pytest.mark.parametrize("fmt", ["razer", "int4"])
def test_gptq_equals_reference(fmt, group_size, block_size, dead, damp):
    w, x = _case(d_in=256 if group_size == 128 else 128, dead=dead)
    jf, tf = _factories(fmt, group_size)
    want = jgptq.gptq_quantize(w, x, jf, group_size=group_size, block_size=block_size, damp=damp)
    got = tgptq.gptq_quantize(w, x, tf, group_size=group_size, block_size=block_size, damp=damp, device="cpu")
    assert got.dtype == torch.float32 and got.shape == w.shape
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32)), int((got.numpy() != want).sum())
    assert got[3].any() == (not (dead and damp == 0.0))  # zeroed only where the dead branch runs


def test_gptq_beats_round_to_nearest():
    w, x = _case()
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    ref = tx @ tw
    rtn = float(((tx @ trazer(tw, axis=0).dequantize() - ref) ** 2).mean())
    q = tgptq.gptq_quantize(w, x, tgptq.make_group_quantizer(lambda g: trazer(g, axis=0, scale_fmt="e3m3")),
                            group_size=16, block_size=32, device="cpu")
    assert float(((tx @ q - ref) ** 2).mean()) < rtn


def test_gptq_runs_on_the_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w, x = _case(d_in=32, d_out=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgptq.gptq_quantize(w, x, tgptq.make_group_quantizer(lambda g: trazer(g, axis=0)), group_size=16,
                            block_size=32)
    with pytest.raises(ValueError):
        tgptq.gptq_quantize(w, x, None, group_size=24, block_size=32, device="cpu")
