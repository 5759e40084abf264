"""The port's entry points (``glava_tpu_torch.entry_points``) against the
root ``__graft_entry__.py``.

``entry(device="cpu")``'s bars frame at 512x256 against ``jax.jit`` of
the JAX ``entry()``'s fn, and a second step of each from JAX's state
carried across (``interop.state_from_jax_numpy``). Tolerance: the golden
rule, under 0.2% of pixels more than 2 LSB apart. ``dryrun_multichip``
on eight CPU devices prints its five OK lines, as the JAX dry run does
on its eight virtual CPU devices (``tests/test_runtime.py``), and its
serving loop draws every stream however late the synth threads start.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from glava_tpu.renderer import quantize_frame
from glava_tpu_torch import entry_points, interop
from glava_tpu_torch.config import loader


def golden_fraction(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    return float((np.abs(got.astype(np.int16) - want.astype(np.int16)) > 2).mean())


def test_entry_meets_jax_entry_for_two_steps():
    jfn, jargs = graft.entry()
    jstep = jax.jit(jfn)
    jstate, jframe = jstep(*jargs)
    fn, args = entry_points.entry(device="cpu")
    assert np.array_equal(args[1].numpy(), np.asarray(jargs[1]))
    state, frame = fn(*args)
    assert frame.shape == (256, 512, 4) and frame.dtype == torch.float32
    got, want = quantize_frame(frame.numpy()), quantize_frame(jframe)
    assert (got[..., 3] > 0).any()
    assert golden_fraction(got, want) < 0.002

    # a second step of fresh audio from JAX's state carried across
    cfg = loader.load(cli_requests=entry_points.BARS_512,
                      force_module="bars").cfg
    carried = interop.state_from_jax_numpy(jax.tree.map(np.asarray, jstate),
                                           cfg, "cpu")
    audio = (np.random.default_rng(1).standard_normal((2, cfg.bufsize))
             .astype(np.float32) * 0.2)
    _, jframe2 = jstep(jstate, jnp.asarray(audio), *jargs[2:])
    _, frame2 = fn(carried, torch.as_tensor(audio), *args[2:])
    got2, want2 = quantize_frame(frame2.numpy()), quantize_frame(jframe2)
    assert not np.array_equal(got2, got)
    assert golden_fraction(got2, want2) < 0.002


def test_dryrun_multichip_on_eight_cpu_devices(capsys):
    # a small scaling table: eight copies of one CPU show no scaling,
    # and the card's 64 streams a device x 8 updates are heavy here
    entry_points.dryrun_multichip(8, devices=["cpu"] * 8, per_device=2,
                                  updates=2)
    lines = capsys.readouterr().out.splitlines()
    ok = [ln.split(":")[0] for ln in lines if " OK:" in ln]
    assert ok == ["dryrun_multichip OK", "dryrun_multichip realistic OK",
                  "dryrun_multichip scaling OK", "dryrun_multichip hosts OK",
                  "dryrun_multichip engine_8dev OK"], lines
    assert "mesh={'streams': 4, 'rows': 2}" in lines[1]
    assert "per-device frame=(1, 540, 1920, 4)" in lines[2]


def test_dryrun_fleet_engine_waits_for_late_audio(monkeypatch, capsys):
    """The dry run's serving loop starts once every synth thread has
    delivered: threads that start 2 s late still draw every stream."""
    from glava_tpu_torch.runtime.audio import synth

    entry = synth.SynthBackend.entry

    def late(self, audio):
        time.sleep(2.0)
        entry(self, audio)

    monkeypatch.setattr(synth.SynthBackend, "entry", late)
    entry_points._dryrun_fleet_engine([torch.device("cpu")] * 2, 2)
    assert "(8/8 streams drew pixels)" in capsys.readouterr().out


def test_dryrun_scaling_table_divides_the_update_bytes():
    table = entry_points._scaling_table([torch.device("cpu")] * 2, 2,
                                        per_device=2, updates=2)
    assert table["1dev"]["streams"] == 2 and table["2dev"]["streams"] == 4
    assert table["per_device_update_bytes"]["division_efficiency"] == 1.0
    assert table["weak_scaling_efficiency"] > 0
    assert "2 shards on 1 distinct device" in table["note"]


def test_dryrun_devices_repeat_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert entry_points._devices(4, None) == [
        torch.device(f"cuda:{i}") for i in (0, 1, 0, 1)]
    with pytest.raises(ValueError, match="3 devices given"):
        entry_points._devices(4, ["cpu"] * 3)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        entry_points.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry_points.dryrun_multichip(2)
