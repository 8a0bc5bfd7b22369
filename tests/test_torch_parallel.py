"""PyTorch port: the distributed paths on gloo worlds of 2 and 4 spawned
ranks (modulation_mfcc_tpu_torch/dryrun.py) against the JAX package on its
virtual 8-device CPU mesh, on the same numpy-seeded inputs.

Each world is spawned once per module (a module-scoped fixture runs every
rank program and keeps rank 0's results); the tests assert on those
results. Every rank also checks itself against the unsharded result
(dryrun.certify), so a world that returns at all has passed those checks."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modulation_mfcc_tpu.models.config import MfccConfig as JaxMfccConfig
from modulation_mfcc_tpu.parallel import batch as jax_batch
from modulation_mfcc_tpu.parallel import mesh as jax_mesh
from modulation_mfcc_tpu.parallel import multislice as jax_multislice
from modulation_mfcc_tpu.parallel import streaming as jax_streaming
from modulation_mfcc_tpu_torch import MfccConfig, mfcc_change
from modulation_mfcc_tpu_torch import dryrun
from modulation_mfcc_tpu_torch.parallel import corpus, multislice, streaming
from tests.test_torch_corpus import assert_dirs_close, make_tiny_corpus
from tests.test_torch_modulation import speechlike

torch.set_num_threads(1)

SMALL = dict(n_fft=256, n_mels=40)  # tests/test_parallel.py's small_cfg
LONG_LENGTHS = (64_000, 64_000 + 4321)  # the second divides by neither 2 nor 4
SWEEP_FEATURES = ("mod_cepstr", "f0", "envelope", "mfcc39", "formants")


def ragged() -> tuple[np.ndarray, np.ndarray]:
    """test_torch_corpus.py's batched-test input: four speech-like
    utterances at 10 kHz (seeds 30-33), padded to 65,536 samples."""
    lengths = np.array([41_000, 38_500, 20_000, 9_000])
    y = np.zeros((4, 65_536), np.float32)
    for i, n in enumerate(lengths):
        y[i, :n] = speechlike(n / 10_000, 10_000, seed=30 + i)[:n] * 0.5
    return y, lengths


def long_signals() -> list[np.ndarray]:
    rng = np.random.default_rng(20260816)
    return [rng.standard_normal(n).astype(np.float32) for n in LONG_LENGTHS]


def certify_inputs() -> dict:
    y, lengths = ragged()
    return dict(cfg=MfccConfig(), samples=y, lengths=lengths, spectrum="fft", long=long_signals(),
                long_cfg=MfccConfig(**SMALL))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_corpus(tmp_path_factory.mktemp("corpus"))


@pytest.fixture(scope="module")
def world2(tiny, tmp_path_factory):
    """certify on a gloo world of 2, then the corpus sweep over a (2, 1)
    mesh; rank 0's results and the sweep's output directory."""
    out = str(tmp_path_factory.mktemp("mesh_sweep") / "feats")
    sweep_kw = dict(paths=tiny, out_dir=out, cfg=MfccConfig(), batch_size=3, bucket_multiple=32_768,
                    spectrum="fft", features=SWEEP_FEATURES)
    results = dryrun.spawn(2, [("certify", certify_inputs()), ("mesh_sweep", sweep_kw)], timeout_s=240)
    return results[0][0], results[0][1], out


@pytest.fixture(scope="module")
def world4():
    return dryrun.spawn(4, [("certify", certify_inputs())], timeout_s=240)[0][0]


def jax_sharded(n: int):
    y, lengths = ragged()
    tot, mask, mean = jax_batch.sharded_mfcc_change(
        jax_batch.AudioBatch(jnp.asarray(y), jnp.asarray(lengths)), JaxMfccConfig(), jax_mesh.make_mesh(n, 1),
        spectrum="fft")
    return np.asarray(tot), np.asarray(mask), float(mean)


def assert_sharded_matches(got: tuple, want: tuple) -> None:
    """tot·mask ≤ 1e-5 (test_torch_corpus.py's batched bar), masks equal,
    corpus mean within 1e-5 relative."""
    tot, mask, mean = got
    np.testing.assert_array_equal(mask, want[1])
    np.testing.assert_allclose(tot * mask, want[0] * want[1], rtol=0, atol=1e-5)
    assert abs(mean - want[2]) <= 1e-5 * abs(want[2])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_mfcc_change_matches_jax(world, request):
    res = request.getfixturevalue(f"world{world}") if world == 4 else request.getfixturevalue("world2")[0]
    assert_sharded_matches(res["data"], jax_sharded(world))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_uneven_batch_equals_unsharded(world, request):
    """Three rows over 2 or 4 ranks (padded with copies of the last row,
    then cut back) equal the unsharded batch, mean included."""
    res = request.getfixturevalue(f"world{world}") if world == 4 else request.getfixturevalue("world2")[0]
    y, lengths = ragged()
    assert res["errors"]["data_uneven"] <= 1e-5
    tot, mask, mean = res["data_uneven"]
    assert tot.shape[0] == 3
    ref = mfcc_change(torch.tensor(y[:3]), MfccConfig(), frame_lengths=torch.tensor(1 + lengths[:3] // 50),
                      spectrum="fft").numpy()
    np.testing.assert_allclose(tot * mask, ref * mask, rtol=0, atol=1e-5)
    assert abs(mean - float((ref * mask).sum() / mask.sum())) <= 1e-5 * abs(mean)


def test_multislice_matches_jax(world4):
    """The port's ("slice", "data", "time") = (2, 2, 1) world against JAX on
    make_multislice_mesh(2, 2, 2) (tests/test_parallel.py's layout)."""
    y, lengths = ragged()
    tot, mask, mean = jax_multislice.multislice_sharded_mfcc_change(
        jax_batch.AudioBatch(jnp.asarray(y), jnp.asarray(lengths)), JaxMfccConfig(),
        jax_multislice.make_multislice_mesh(2, 2, 2), spectrum="fft")
    assert_sharded_matches(world4["multislice"], (np.asarray(tot), np.asarray(mask), float(mean)))
    assert abs(world4["multislice"][2] - world4["data"][2]) <= 1e-6 * abs(world4["data"][2])


@pytest.mark.parametrize("world", [2, 4])
def test_time_sharded_longform_matches_jax_and_whole_file(world, request):
    """n = 2 and 4 time shards, at 64,000 samples and at 68,321 (which
    neither divides): ≤ 1e-4 from JAX's sharded_longform_mfcc_change on
    make_mesh(1, n) (its own test's bar), and ≤ 1e-5 from the port's
    whole-file mfcc_change (checked in every rank too)."""
    res = request.getfixturevalue(f"world{world}") if world == 4 else request.getfixturevalue("world2")[0]
    for got, y in zip(res["long"], long_signals()):
        want = np.asarray(jax_streaming.sharded_longform_mfcc_change(
            jnp.asarray(y), JaxMfccConfig(**SMALL), jax_mesh.make_mesh(1, world)))
        whole = mfcc_change(torch.tensor(y), MfccConfig(**SMALL)).numpy()
        assert got.shape == want.shape == whole.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, whole, rtol=0, atol=1e-5)


def test_per_shard_step_on_one_device():
    """shard_mel / shard_mfcc run shard by shard on one device, halos sliced
    from the whole signal (extended_shard), with the max of the shards'
    peaks, equal the whole-file result: the step chip_smoke.py runs for four
    shards of an hour on one card."""
    y = torch.tensor(long_signals()[1])
    cfg = MfccConfig(**SMALL)
    whole = mfcc_change(y, cfg)
    for n_t in (3, 4):
        g = streaming.longform_shards(y.shape[0], cfg, n_t)
        mels = [streaming.shard_mel(streaming.extended_shard(y, i, g), i, n_t, g.t_true, cfg) for i in range(n_t)]
        peak = torch.stack([p for _, p in mels]).max()
        m = torch.cat([streaming.shard_mfcc(mel, peak, i, n_t, g.t_true, cfg) for i, (mel, _) in enumerate(mels)])
        got = streaming._trajectory_postprocess(m[: g.nf_total], cfg)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_extras_equal_unsharded(world, request):
    """The sweep's extras (f0, envelope, formants, mfcc39) on each rank's
    rows, all-gathered, equal the unsharded batch: valid masks and NaN
    patterns exactly, values to 1e-4 (formants and bandwidths 0.05 Hz)."""
    res = request.getfixturevalue(f"world{world}") if world == 4 else request.getfixturevalue("world2")[0]
    for key in ("mfcc39", "f0", "envelope", "formants", "formant_bw"):
        assert res["errors"][f"extra_{key}"] <= dryrun.EXTRA_BARS.get(key, 1e-4), key
        vals, valid = res[f"extra_{key}"]
        assert vals.shape[0] == valid.shape[0] == 4 and valid.any(axis=-1).all()


def test_mesh_sweep_equals_unsharded(world2, tiny, tmp_path):
    """The sweep over a gloo (2, 1) mesh writes the unsharded sweep's files,
    keys and values (mod_cepstr 1e-5, mfcc39/f0 1e-4 with the same voicing,
    envelope 1e-6, formants 0.05 Hz with the same NaN pattern; times
    exactly); rank 0 alone wrote them, and every rank counted every file."""
    _, report, out = world2
    assert report["items"] == 5
    ref = tmp_path / "ref"
    corpus.sweep_mfcc_change(tiny, corpus.CorpusSweep(str(ref), cfg=MfccConfig(), batch_size=3,
                                                      bucket_multiple=32_768, spectrum="fft", device="cpu",
                                                      features=SWEEP_FEATURES))
    assert sorted(open(os.path.join(out, "_done.txt")).read().split()) == sorted((ref / "_done.txt").read_text().split())
    assert_dirs_close(out, ref)


def test_shard_manifest_matches_jax():
    paths = [f"f{i}.wav" for i in range(11)]
    for n in (1, 3, 4):
        shards = [multislice.shard_manifest(paths, n, s) for s in range(n)]
        assert shards == [jax_multislice.shard_manifest(paths, n, s) for s in range(n)]
        assert sorted(sum(shards, [])) == sorted(paths)
        assert max(map(len, shards)) - min(map(len, shards)) <= 1
    with pytest.raises(ValueError):
        multislice.shard_manifest(paths, 3, 3)


def test_init_distributed_false_without_environment(monkeypatch):
    """Without PyTorch's launcher environment (and no init_method) there is
    no process group to join: False, as JAX's without its coordinator."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert multislice.init_distributed() is False
    assert jax_multislice.init_distributed() is False
