"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, everything else of a run driven on the
CPU at a tiny size.  The faults these cells can have: an answer altered
where it is produced, and (served) half of a batch left unsolved."""

import pytest

from .conftest import SEED, cells_of


def _run(name, root):
    from slatebench import run as runner

    return runner.execute(name, SEED, 0.3, False, device="cpu", root=root)[1]


def test_a_solve_whose_answer_is_altered_is_caught(tiny_root, bench,
                                                   monkeypatch):
    import slate_tpu_torch as st

    gesv = st.gesv

    def altered(A, B, opts=None):
        X, perm, info = gesv(A, B, opts)
        X = X.clone()
        X[0] += 1e-6 * float(X.abs().max())
        return X, perm, info

    monkeypatch.setattr(st, "gesv", altered)
    for name in cells_of(bench, "dense_solve"):
        res = _run(name, tiny_root)
        assert res["correct"] is False
        assert res["checks"]["resid_max"]["value"] > 16.0


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
def test_a_served_batch_broken_in_its_core_is_caught(tiny_root, bench,
                                                     monkeypatch, fault):
    from slate_tpu_torch.serve import batched

    for routine, core in list(batched.CORES.items()):
        def broken(a, b, core=core):
            x, *rest = core(a, b)
            x = x.clone()
            if fault == "altered":
                x[..., 0, 0] += 1e-2 * x.abs().amax()
            else:
                x[x.shape[0] // 2:] = 0
            return (x, *rest)
        monkeypatch.setitem(batched.CORES, routine, broken)
    for name in cells_of(bench, "serve_queue"):
        res = _run(name, tiny_root)
        assert res["correct"] is False, (name, res["checks"])
        assert res["checks"]["gap_max"]["value"] > \
            res["checks"]["gap_max"]["limit"]
