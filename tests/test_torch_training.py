"""The port's training plumbing on the CPU: data against the JAX package,
checkpoints, and the ``train`` launcher end to end.

* ``SyntheticLM`` and ``MemmapLM`` batches are byte-equal to the
  reference's for the same (seed, step, shard, n_shards): both draw with
  numpy.
* Checkpoints round-trip every leaf bit for bit (bfloat16 as its int16
  bits), ignore a partial ``tmp.*`` directory, keep the last ``keep``, and
  an asynchronous save holds the values of the moment it was called.
* ``python -m repro_torch.launch.train --smoke --device cpu --f32`` trains
  with a falling loss, saves, and resumes from its checkpoint, as
  ``tests/test_launchers.py`` runs the reference's launcher.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.training import data as jdata
from repro_torch.launch import train
from repro_torch.training import checkpoint, data, optim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (1234, 0, 0, 1), (1234, 7, 1, 2), (3, 123, 3, 4)])
def test_synthetic_batches_are_the_references(seed, step, shard, n_shards):
    cfg = dict(seq_len=24, global_batch=8, vocab_size=97, seed=seed)
    got = data.make_dataset(data.DataConfig(**cfg)).batch(step, shard,
                                                          n_shards)
    want = jdata.make_dataset(jdata.DataConfig(**cfg)).batch(step, shard,
                                                             n_shards)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_memmap_batches_are_the_references(tmp_path):
    path = str(tmp_path / "toks.bin")
    ref_path = str(tmp_path / "ref.bin")
    data.write_token_file(path, 4096, 500, seed=3)
    jdata.write_token_file(ref_path, 4096, 500, seed=3)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    cfg = dict(seq_len=16, global_batch=4, vocab_size=500, source="memmap",
               path=path)
    ds, jds = (data.make_dataset(data.DataConfig(**cfg)),
               jdata.make_dataset(jdata.DataConfig(**cfg)))
    for step, shard, n in ((0, 0, 1), (5, 1, 2)):
        got, want = ds.batch(step, shard, n), jds.batch(step, shard, n)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), (step, k)


def test_device_batch_on_the_cpu():
    host = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
            "frames": np.ones((2, 2), np.float32)}
    out = data.device_batch(host, "cpu")
    assert out["tokens"].dtype == torch.int32
    assert out["frames"].dtype == torch.float32
    assert out["tokens"].tolist() == host["tokens"].tolist()


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(3, 4, generator=gen),
              "e": torch.randn(5, generator=gen).to(torch.bfloat16)}
    opt = optim.Adam()
    return params, optim.OptState(torch.tensor(7, dtype=torch.int32),
                                  {k: v * 2 for k, v in params.items()},
                                  {k: v * 3 for k, v in params.items()}), opt


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_round_trip_bit_exact(tmp_path):
    params, state, _ = _state()
    checkpoint.save(str(tmp_path), 5, (params, state), meta={"loss": 1.5})
    like = ({k: torch.zeros_like(v) for k, v in params.items()},
            optim.OptState(torch.tensor(0, dtype=torch.int32),
                           {k: torch.zeros_like(v) for k, v in
                            params.items()},
                           {k: torch.zeros_like(v) for k, v in
                            params.items()}))
    (p2, s2), step, meta = checkpoint.restore(str(tmp_path), like)
    assert step == 5 and meta == {"loss": 1.5}
    assert isinstance(s2, optim.OptState) and int(s2.step) == 7
    for k in params:
        assert _equal(p2[k], params[k])
        assert _equal(s2.mu[k], state.mu[k])
        assert _equal(s2.nu[k], state.nu[k])
    manifest = json.load(open(tmp_path / "step_0000000005" /
                              "manifest.json"))
    by_path = {e["path"]: e for e in manifest["leaves"]}
    assert by_path["[0]['e']"]["dtype"] == "bfloat16"
    assert by_path["[0]['e']"]["bits"] == "int16"
    assert by_path["[1].step"]["dtype"] == "int32"


def test_checkpoint_ignores_partial_and_keeps_last_k(tmp_path):
    params, state, _ = _state()
    for step in (1, 2, 3, 4):
        checkpoint.save(str(tmp_path), step, (params, state), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]
    # A save that died mid-write leaves a tmp directory and, at worst, a
    # step directory without its manifest: neither counts.
    os.makedirs(tmp_path / "tmp.9.123")
    os.makedirs(tmp_path / "step_0000000009")
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert checkpoint.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "absent"), (params, state))


def test_async_save_snapshots_before_returning(tmp_path):
    params, state, _ = _state()
    before = params["w"].clone()
    saver = checkpoint.save(str(tmp_path), 1, (params, state),
                            blocking=False)
    params["w"].add_(1.0)             # the next step updates in place
    saver.join()
    (p2, _), _, _ = checkpoint.restore(str(tmp_path), (params, state))
    assert torch.equal(p2["w"], before)


def _run_cli(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], capture_output=True, text=True,
                         timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    return out.stdout


def test_train_launcher_and_resume(tmp_path):
    ckpt = str(tmp_path / "ck")
    common = ["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu",
              "--f32", "--batch", "2", "--seq", "32", "--ckpt-dir", ckpt]
    out = _run_cli(common + ["--steps", "24", "--ckpt-every", "12",
                             "--log-every", "12"])
    first = json.loads(out.strip().splitlines()[-1])
    assert first["final_loss"] < first["first_loss"]
    assert first["steps_run"] == 24
    assert checkpoint.latest_step(ckpt) == 24
    out2 = _run_cli(common + ["--steps", "30", "--resume",
                              "--log-every", "6"])
    assert "resumed from step 24" in out2
    assert json.loads(out2.strip().splitlines()[-1])["steps_run"] == 6


def test_train_launcher_rejects_a_mesh():
    """A mesh of more than one device needs a torchrun-style world of its
    size; without one the launcher raises, and never trains unsharded."""
    with pytest.raises(ValueError, match="torchrun-style world of 4 ranks"):
        train.main(["--smoke", "--device", "cpu", "--mesh", "2x2"])
