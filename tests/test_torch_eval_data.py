"""The port's evaluation data (``data/synthetic.py::token_stream``,
``data/pipeline.py::eval_batches``, ``LMDataset.epoch_steps`` and
``iter_from``) against the JAX package's, bit-exact."""
import itertools

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch.data import pipeline, synthetic


@pytest.mark.parametrize("start", [0, 17, synthetic.CHUNK - 5, 3 * 10 ** 6])
def test_token_stream_equals_the_reference(start):
    """From several starts, one of them 5 tokens before a 65,536-token
    chunk boundary, so the stream crosses it."""
    cfg, jcfg = synthetic.SyntheticConfig(vocab=384, seed=2), \
        jsyn.SyntheticConfig(vocab=384, seed=2)
    got = list(itertools.islice(synthetic.token_stream(cfg, start), 40))
    want = list(itertools.islice(jsyn.token_stream(jcfg, start), 40))
    assert got == want and all(type(t) is int for t in got)


@pytest.mark.parametrize("offset", [None, 3])
def test_eval_batches_equal_the_reference(offset):
    kw = dict(vocab=512, seq_len=16, global_batch=4, seed=1, n_examples=8)
    args = (3,) if offset is None else (3, offset)
    got = pipeline.eval_batches(pipeline.DataConfig(**kw), *args)
    want = jpipe.eval_batches(jpipe.DataConfig(**kw), *args)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_epoch_steps_and_iter_from_equal_the_reference():
    for n_ex, batch in ((8, 4), (10, 4), (3, 8)):
        kw = dict(vocab=256, seq_len=8, global_batch=batch, seed=0,
                  n_examples=n_ex)
        ds, jds = pipeline.LMDataset(pipeline.DataConfig(**kw)), \
            jpipe.LMDataset(jpipe.DataConfig(**kw))
        assert ds.epoch_steps() == jds.epoch_steps()
        for g, w in zip(itertools.islice(ds.iter_from(5), 3),
                        itertools.islice(jds.iter_from(5), 3)):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    infinite = pipeline.LMDataset(pipeline.DataConfig(256, 8, 4))
    with pytest.raises(ValueError, match="no epochs"):
        infinite.epoch_steps()
