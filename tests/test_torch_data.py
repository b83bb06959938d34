"""Port's data pipeline (``repro_torch/data/pipeline.py``, a numpy copy)
against the JAX package's: every batch bit-identical (``np.array_equal``,
no tolerance), over steps, host splits and elastic resharding."""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as pipe

CONFIGS = [dict(vocab_size=512, seq_len=32, global_batch=8, seed=1),
           dict(vocab_size=50_304, seq_len=64, global_batch=4, seed=0),
           dict(vocab_size=3, seq_len=17, global_batch=6, seed=7,
                n_patterns=5, pattern_len=3)]


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: f"V{kw['vocab_size']}")
def test_synthetic_batch_matches_reference(kw):
    cfg, jcfg = pipe.DataConfig(**kw), jpipe.DataConfig(**kw)
    for step in (0, 1, 5, 1000):
        _same(pipe.synthetic_batch(cfg, step), jpipe.synthetic_batch(jcfg, step))
        _same(pipe.synthetic_batch(cfg, step, row_start=1, n_rows=2),
              jpipe.synthetic_batch(jcfg, step, row_start=1, n_rows=2))


def test_hash2_matches_reference():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2**63, size=64, dtype=np.uint64)
    b = rng.randint(0, 2**63, size=64, dtype=np.uint64)
    for seed in (0, 1, 12345):
        assert np.array_equal(pipe._hash2(a, b, seed), jpipe._hash2(a, b, seed))


@pytest.mark.parametrize("n_hosts", [1, 2, 4, 8])
def test_host_iterator_matches_reference(n_hosts):
    kw = CONFIGS[0]
    cfg, jcfg = pipe.DataConfig(**kw), jpipe.DataConfig(**kw)
    for h in range(n_hosts):
        ours = pipe.host_iterator(cfg, h, n_hosts, start_step=3)
        ref = jpipe.host_iterator(jcfg, h, n_hosts, start_step=3)
        for a, b in itertools.islice(zip(ours, ref), 4):
            _same(a, b)
            assert pipe.batch_checksum(a) == jpipe.batch_checksum(b)


def test_elastic_resharding_matches_reference():
    """The union of the host shards is the global batch at every host
    count, and a restart with another host count resumes the same
    stream."""
    kw = CONFIGS[0]
    cfg, jcfg = pipe.DataConfig(**kw), jpipe.DataConfig(**kw)
    for step in (0, 5):
        full = jpipe.synthetic_batch(jcfg, step)
        for n_hosts in (1, 2, 4, 8):
            shards = [next(pipe.host_iterator(cfg, h, n_hosts,
                                              start_step=step))
                      for h in range(n_hosts)]
            for k in full:
                assert np.array_equal(
                    np.concatenate([s[k] for s in shards]), full[k])


def test_batch_checksum_matches_reference():
    kw = CONFIGS[1]
    cfg, jcfg = pipe.DataConfig(**kw), jpipe.DataConfig(**kw)
    sums = [pipe.batch_checksum(pipe.synthetic_batch(cfg, s))
            for s in range(4)]
    assert sums == [jpipe.batch_checksum(jpipe.synthetic_batch(jcfg, s))
                    for s in range(4)]
    assert len(set(sums)) == 4
