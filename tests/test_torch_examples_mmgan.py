"""The port's MM-GAN-side example harnesses (``gandes_tpu_torch/examples/``:
``ingest_bench``, ``train_surrogate_demo``, ``ref_schedule_run``) against the
JAX harnesses of ``examples/`` on the same inputs, on the CPU.

- ingest: ``build_corpus(n_files=8, concat=4, n_base=8)`` writes the same
  bytes in both packages; the port's three modes (``workers=2``, and
  ``device_rasterize`` on the CPU, which takes K1's plain version) give
  windows bitwise equal to the JAX sequential pickle.
- surrogate demo: ``build_dataset(n_nets=2)`` windows bitwise; ``gap`` on
  the same rolls within 1e-6 relative; ``generated_rolls`` with the JAX
  state carried across (``mmgan_train_state_from_flax``) and the JAX noise
  and aux draws injected: G's outputs at atol 2e-4, and the rolls bitwise
  where both packages decode the JAX outputs (the decode flips notes on
  last-bit differences of G); one ``run`` writes ``RESULTS.json`` with the
  JAX harness's keys.
- ref schedule: ``build_corpus`` at a small ``GANDES_REFSCHED_WINDOWS`` gives
  the JAX harness's windows bitwise; a 1-epoch call and a 2-epoch call that
  resumes equal a straight 2-epoch run bitwise (loss pickles and params);
  the parser refuses ``--recycle-every``.

One torch thread, B = 2 and at most two sim threads (the training configs
are narrowed in the test, not in the harnesses).
"""

import ast
import dataclasses
import glob
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from gandes_tpu.des import native as jax_native
from gandes_tpu.train import mmgan_loop as jax_loop
from gandes_tpu_torch.des import native
from gandes_tpu_torch.examples import ingest_bench, ref_schedule_run, train_surrogate_demo
from gandes_tpu_torch.train import mmgan_loop
from gandes_tpu_torch.train.convert import mmgan_train_state_from_flax

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)
import ingest_bench as jax_ingest  # noqa: E402
import ref_schedule_run as jax_ref  # noqa: E402
import train_surrogate_demo as jax_demo  # noqa: E402

B = 2
G_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _des_libs_loaded():
    """Both packages' native DES cores are loaded before any sim runs under
    a wall budget: a cold g++ build must not count as a sim's time."""
    assert jax_native.get_lib() is not None
    assert native.get_lib() is not None


def _windows(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_windows_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype, i
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"window {i}")


def _results_keys(module) -> set:
    """The keys of the ``results`` dict literal in a JAX harness's source."""
    tree = ast.parse(open(module.__file__).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "results" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no results dict in {module.__file__}")


# ------------------------------------------------------------------ ingest


@pytest.fixture(scope="module")
def ingest(tmp_path_factory):
    """Both corpora, the JAX sequential pickle and the port's three-mode run
    (its pickles stay in its workdir)."""
    base = tmp_path_factory.mktemp("ingest")
    jax_root, jax_bytes = jax_ingest.build_corpus(str(base / "jax"), n_files=8, concat=4,
                                                  n_base=8)
    root, nbytes = ingest_bench.build_corpus(str(base / "torch"), n_files=8, concat=4,
                                             n_base=8)
    jax_pkl = str(base / "jax.pkl")
    from gandes_tpu.data.datasets import build_window_pickle as jax_pickle

    jax_pickle(jax_root, jax_pkl, sequence_length=50)
    # the corpus files exist, so run() keeps them (its own bases are extra)
    summary, launches = ingest_bench.run(str(base / "torch"), n_files=8, concat=4, workers=2,
                                         device="cpu")
    return {"jax_root": jax_root, "root": root, "bytes": (jax_bytes, nbytes), "jax_pkl": jax_pkl,
            "workdir": str(base / "torch"), "summary": summary, "launches": launches}


def test_ingest_corpus_bytes_match_jax(ingest):
    files = sorted(os.path.relpath(p, ingest["root"])
                   for p in glob.glob(os.path.join(ingest["root"], "**", "*.midi"),
                                      recursive=True))
    jax_files = sorted(os.path.relpath(p, ingest["jax_root"])
                       for p in glob.glob(os.path.join(ingest["jax_root"], "**", "*.midi"),
                                          recursive=True))
    assert files == jax_files and len(files) == 8
    for rel in files:
        with open(os.path.join(ingest["root"], rel), "rb") as a, \
                open(os.path.join(ingest["jax_root"], rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert ingest["bytes"][0] == ingest["bytes"][1]
    # multi-minute files (~4x a single sim MIDI), as the JAX ingestion test asks
    assert max(os.path.getsize(os.path.join(ingest["root"], r)) for r in files) > 30_000


@pytest.mark.parametrize("mode", ["sequential", "workers2", "device_rasterize"])
def test_ingest_modes_match_jax_sequential_pickle(ingest, mode):
    ours = _windows(os.path.join(ingest["workdir"], f"windows_{mode}.pkl"))
    _assert_windows_equal(ours, _windows(ingest["jax_pkl"]))
    s = ingest["summary"]
    assert s["identical_outputs"] is True and s["corpus_files"] == 8
    assert s["results"][mode]["windows"] == len(ours)
    assert ingest["launches"][mode] == 0  # the CPU takes K1's plain version


def test_ingest_digest_mismatch_raises(tmp_path, monkeypatch):
    """The harness's identity check is a check: pickles that differ raise."""
    digests = iter(["a", "b", "a"])
    monkeypatch.setattr(ingest_bench, "windows_digest", lambda path: next(digests))
    monkeypatch.setattr(ingest_bench, "build_corpus",
                        lambda workdir, n_files, concat: (str(tmp_path), 1))
    monkeypatch.setattr("gandes_tpu_torch.data.datasets.build_window_pickle",
                        lambda *a, **k: 0)
    with pytest.raises(AssertionError, match="pickles diverge"):
        ingest_bench.run(str(tmp_path), workers=2, device="cpu")


# ------------------------------------------------------- surrogate demo


@pytest.fixture(scope="module")
def demo_data(tmp_path_factory):
    base = tmp_path_factory.mktemp("surrogate_demo")
    jax_pkl = jax_demo.build_dataset(str(base / "jax"), n_nets=2)
    pkl = train_surrogate_demo.build_dataset(str(base / "torch"), n_nets=2)
    return {"jax_pkl": jax_pkl, "pkl": pkl, "base": base}


def test_demo_dataset_matches_jax(demo_data):
    _assert_windows_equal(_windows(demo_data["pkl"]), _windows(demo_data["jax_pkl"]))


def _random_rolls(seed, batch=5):
    rng = np.random.RandomState(seed)
    cells = rng.rand(batch, 2, 128, 50) < 0.03
    return (rng.randint(1, 127, (batch, 2, 128, 50)) * cells).astype(np.float32)


def test_demo_gap_matches_jax(demo_data):
    real = np.stack([np.stack([r, d]) for r, d, _ in _windows(demo_data["pkl"])])
    for fake in (_random_rolls(0), _random_rolls(1, 3), np.zeros((2, 2, 128, 50), np.float32)):
        ours, ref = train_surrogate_demo.gap(real, fake), jax_demo.gap(real, fake)
        assert ours.keys() == ref.keys() and "pitch_class_l1" in ours
        for k in ref:
            assert ours[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-12), k


def test_generated_rolls_match_jax(demo_data, monkeypatch):
    """The JAX harness's ``generated_rolls`` at B = 2 from the JAX initial
    state, its three ``jax.random.normal`` draws (noise1, noise2, G1's aux
    block) recorded and injected into the port's; the port's G outputs
    against the JAX ones, then the port's decode of the JAX outputs against
    the JAX decode, after the same ``np.random.seed``."""
    from gandes_tpu.bridge import mmgan_decode as jax_decode
    from gandes_tpu_torch.bridge import mmgan_decode

    workdir = str(demo_data["base"] / "gen")
    os.makedirs(os.path.join(workdir, "logs"))
    jcfg = jax_loop.MMGANConfig(batch_size=B, start=0, sequence_length=50, lr=1e-3)
    state, _, _ = jax_loop.init_state_for_config(jcfg, batch_size=B)
    draws, jax_calls = [], []
    normal, jax_mtm = jax.random.normal, jax_decode.matrix_to_midi

    def recording_normal(*args, **kw):
        out = normal(*args, **kw)
        draws.append(np.asarray(out))
        return out

    def recording_mtm(g1, g2, **kw):
        jax_calls.append((np.array(g1), np.array(g2), kw))
        return jax_mtm(g1, g2, **kw)

    monkeypatch.setattr(jax.random, "normal", recording_normal)
    monkeypatch.setattr(jax_decode, "matrix_to_midi", recording_mtm)
    np.random.seed(3)
    with jax.disable_jit():
        jax_rolls, jax_failed = jax_demo.generated_rolls(state, jcfg, B, seed=99,
                                                         workdir=workdir)
    monkeypatch.undo()
    assert len(draws) == 3 and all(d.shape == (B, 50) for d in draws)
    assert len(jax_calls) == 1 and jax_calls[0][2]["parallel"] == 16

    pcfg = mmgan_loop.MMGANConfig(batch_size=B, start=0, sequence_length=50, lr=1e-3)
    port = mmgan_train_state_from_flax(jax.device_get(state), pcfg)
    port_mtm, calls = mmgan_decode.matrix_to_midi, []

    def decode_jax_outputs(g1, g2, **kw):
        np.testing.assert_allclose(g1, jax_calls[0][0], atol=G_ATOL, rtol=0, err_msg="G1")
        np.testing.assert_allclose(g2, jax_calls[0][1], atol=G_ATOL, rtol=0, err_msg="G2")
        calls.append(kw)
        return port_mtm(jax_calls[0][0], jax_calls[0][1], **kw)

    monkeypatch.setattr(mmgan_decode, "matrix_to_midi", decode_jax_outputs)
    np.random.seed(3)
    rolls, failed = train_surrogate_demo.generated_rolls(
        port, pcfg, B, seed=99, workdir=workdir, noise=tuple(torch.from_numpy(np.array(d)) for d in draws),
        parallel=2)
    assert len(calls) == 1 and calls[0]["force_roll"] and calls[0]["parallel"] == 2
    assert rolls.shape == (B, 2, 128, 50) and failed == jax_failed
    np.testing.assert_array_equal(rolls, np.asarray(jax_rolls))


def test_eval_noise_is_a_seeded_torch_draw():
    cfg = mmgan_loop.MMGANConfig()
    a, b = train_surrogate_demo.eval_noise(cfg, 3, 99), train_surrogate_demo.eval_noise(cfg, 3, 99)
    assert len(a) == 3 and all(x.shape == (3, 50) and x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], train_surrogate_demo.eval_noise(cfg, 3, 98)[0])


def test_demo_run_writes_the_jax_results_keys(tmp_path, capsys):
    workdir = str(tmp_path / "run")
    results = train_surrogate_demo.run(workdir, epochs=1, n_nets=2, g_update="surrogate",
                                       batch_size=B, device="cpu")
    with open(os.path.join(workdir, "RESULTS.json")) as f:
        written = json.load(f)
    assert set(written) == set(results) == _results_keys(jax_demo)
    assert written["steps"] >= 1 and written["g_update"] == "surrogate"
    assert written["gap_initial"].keys() == written["gap_final"].keys()
    assert all(np.isfinite(written["disc_loss_per_epoch"] + written["gen_loss_per_epoch"]))
    out = capsys.readouterr().out
    assert "initial gap:" in out and "final gap:" in out and "steps_per_s" in out
    assert os.path.isfile(os.path.join(workdir, "loss_curves.png")) or \
        "loss_curves.png skipped: matplotlib" in out


def test_demo_main_takes_the_jax_arguments_and_the_cpu_switch(monkeypatch):
    seen = {}
    monkeypatch.setattr(train_surrogate_demo, "run", lambda *a, **k: seen.update(args=a, kw=k))
    monkeypatch.setenv("GANDES_DEMO_CPU", "1")
    train_surrogate_demo.main(["out", "24", "24", "surrogate", "1e-4"])
    assert seen["args"] == ("out",)
    assert seen["kw"] == {"epochs": 24, "n_nets": 24, "g_update": "surrogate", "d_lr": 1e-4,
                          "device": "cpu"}
    monkeypatch.delenv("GANDES_DEMO_CPU")
    train_surrogate_demo.main([])
    assert seen["args"] == ("surrogate_demo",)
    assert seen["kw"] == {"epochs": 20, "n_nets": 24, "g_update": "surrogate", "d_lr": None,
                          "device": "cuda"}


# ----------------------------------------------------------- ref schedule


@pytest.fixture(scope="module")
def ref_corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("refsched")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_ref, "TARGET_WINDOWS", 64)
    mp.setattr(ref_schedule_run, "TARGET_WINDOWS", 64)
    try:
        jax_pkl = jax_ref.build_corpus(str(base / "jax"))
        pkl = ref_schedule_run.build_corpus(str(base / "torch"))
    finally:
        mp.undo()
    return {"jax_pkl": jax_pkl, "pkl": pkl, "base": base}


def test_ref_corpus_matches_jax(ref_corpus, capsys):
    ours = _windows(ref_corpus["pkl"])
    _assert_windows_equal(ours, _windows(ref_corpus["jax_pkl"]))
    assert len(ours) >= 64
    # an existing pickle with enough windows is reused
    assert ref_schedule_run.build_corpus(os.path.dirname(ref_corpus["pkl"]),
                                         target_windows=64) == ref_corpus["pkl"]
    assert "corpus: reusing" in capsys.readouterr().out


def _light_config(monkeypatch):
    """The ref schedule's config at B = 2 with two sim threads."""
    cls = mmgan_loop.MMGANConfig
    monkeypatch.setattr(mmgan_loop, "MMGANConfig",
                        lambda **kw: cls(**{**kw, "batch_size": B, "des_parallel": 2}))


def _copy_corpus(ref_corpus, name):
    d = ref_corpus["base"] / name
    d.mkdir()
    (d / "windows.pkl").write_bytes(open(ref_corpus["pkl"], "rb").read())
    return str(d)


def _losses(workdir):
    return {os.path.basename(p): _windows(p)
            for p in sorted(glob.glob(os.path.join(workdir, "losses", "*.pkl")))}


def test_ref_schedule_resume_is_bitwise(ref_corpus, monkeypatch, capsys):
    """Epoch 1, then a call to epoch 2 that resumes from its checkpoint (the
    global numpy stream continuing in the process), against a straight
    2-epoch run from the same numpy seed: the loss pickles and every
    parameter bit for bit."""
    _light_config(monkeypatch)
    kw = dict(target_windows=64, steps_per_epoch=2, device="cpu")
    straight_dir, split_dir = _copy_corpus(ref_corpus, "straight"), _copy_corpus(ref_corpus,
                                                                                  "split")
    np.random.seed(11)
    straight, hist, done = ref_schedule_run.run(straight_dir, 2, **kw)
    assert done["steps"] == 4 and len(hist["disc"]) == 2
    np.random.seed(11)
    _, first, _ = ref_schedule_run.run(split_dir, 1, **kw)
    resumed, second, done2 = ref_schedule_run.run(split_dir, 2, **kw)
    out = capsys.readouterr().out
    assert "Loaded model from models/mmgan_64_64_epoch_1" in out and "DONE: 2 steps" in out
    assert len(first["disc"]) == len(second["disc"]) == 1 and done2["steps"] == 2
    assert _losses(split_dir) == _losses(straight_dir)
    assert sorted(_losses(split_dir)) == [f"{k}_losses_epoch_{e}.pkl" for k in ("disc", "gen")
                                          for e in (1, 2)]
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert straight.step == resumed.step == 4
    assert sorted(os.listdir(os.path.join(split_dir, "models"))) == [
        "mmgan_64_64_epoch_1", "mmgan_64_64_epoch_1_surrogate", "mmgan_64_64_epoch_2",
        "mmgan_64_64_epoch_2_surrogate"]


def test_ref_schedule_config_and_parser(tmp_path):
    """The surrogate schedule of the JAX harness (lr 1e-3, D at 1e-4,
    resume, a checkpoint every epoch); the balance flags reach the config;
    ``--recycle-every`` is refused."""
    seen = {}

    def capture(**kw):
        seen.update(kw)
        raise RuntimeError("stop")

    args = ref_schedule_run.parser().parse_args(
        ["w", "3", "--instance-noise", "2", "--r1-gamma", "0.5", "--r1-mode", "fd",
         "--moment-match", "0.1", "--seed", "4", "--np-seed", "9"])
    assert (args.epochs, args.instance_noise, args.r1_mode, args.np_seed) == (3, 2.0, "fd", 9)
    assert ref_schedule_run.parser().parse_args(["w"]).epochs == 40
    with pytest.raises(SystemExit):
        ref_schedule_run.parser().parse_args(["w", "--recycle-every", "2"])
    mp = pytest.MonkeyPatch()
    mp.setattr(mmgan_loop, "MMGANConfig", capture)
    mp.setattr(ref_schedule_run, "build_corpus", lambda workdir, target: "windows.pkl")
    mp.setattr("gandes_tpu_torch.data.datasets.MaestroDatasetPickle", lambda *a, **k: None)
    try:
        with pytest.raises(RuntimeError, match="stop"):
            ref_schedule_run.main([str(tmp_path), "3", "--r1-gamma", "0.5", "--seed", "4"])
    finally:
        mp.undo()
    assert seen["g_update"] == "surrogate" and seen["lr"] == 1e-3 and seen["d_lr"] == 1e-4
    assert seen["resume"] and seen["save_interval"] == 1 and seen["num_epochs"] == 3
    assert seen["r1_gamma"] == 0.5 and seen["seed"] == 4 and seen["des_parallel"] == 16
    fields = {f.name for f in dataclasses.fields(mmgan_loop.MMGANConfig)}
    assert set(seen) <= fields
