"""``chip_smoke.py``'s bf16 serving judges (``bf16_judge``,
``bf16_pooled``) on CPU tensors: each answer against its plain bf16
version within the bars of its bf16-vs-fp32 gap. Per request, and for the
CNN models over every request of a run at once, where a one-value
request's gap may all but vanish while a correct answer still differs by
a flipped rounding; a wrong answer must fail either way."""
import numpy as np
import pytest
import torch

import chip_smoke


@pytest.mark.parametrize('wrong', [False, True])
def test_pooled_judge_holds_the_run_not_a_vanishing_gap(wrong):
    """A 1-row request whose gap is 1e-3 of the run's, served within a
    flipped rounding, passes; a 1-row answer off by the output's size
    fails the pooled bars."""
    rng = np.random.default_rng(0)
    pooled, answers = {}, []
    for rows, err, gap in ((1, 5e-6 if not wrong else 1.0, 1e-6),
                           (300, 5e-6, 1e-3), (4096, 5e-6, 1e-3)):
        want = [torch.from_numpy(
            rng.normal(size=(rows, 1)).astype(np.float32)) for _ in range(2)]
        fp32 = [w + gap for w in want]
        got = [(w + err).numpy() for w in want]
        answers.append((want, fp32))
        judge = chip_smoke.bf16_judge(
            'toy', lambda x, call: answers[-1][0],
            lambda x, call: answers[-1][1], pooled)
        res = judge(torch.zeros(rows, 1), 0, *got)
        assert set(res) == {'mean', 'ue'}
    if wrong:
        with pytest.raises(RuntimeError, match='every request'):
            chip_smoke.bf16_pooled('toy', pooled)
    else:
        out = chip_smoke.bf16_pooled('toy', pooled)
        assert out['ue']['max_abs_err'] <= out['ue']['bar_max']
        assert len(pooled['ue']) == 3


def test_judge_without_pool_gates_each_request():
    """Without a pool each request is held to its own gap's bars."""
    rows = 4
    want = [torch.ones(rows, 1), torch.ones(rows, 1)]
    fp32 = [w + 1e-3 for w in want]
    judge = chip_smoke.bf16_judge('toy', lambda x, call: want,
                                  lambda x, call: fp32)
    ok = judge(torch.zeros(rows, 1), 0, *[(w + 1e-5).numpy() for w in want])
    assert ok['mean']['max_abs_err'] <= ok['mean']['bar_max']
    with pytest.raises(RuntimeError, match='toy 4-row mean'):
        judge(torch.zeros(rows, 1), 0, *[(w + 1e-2).numpy() for w in want])
