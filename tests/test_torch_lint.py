"""The port's AST lint (``repro_torch.analysis.lint``): the reference's
three carried-over rules give the reference's ``(rule, line)`` set on the
port's ``serving/`` and ``models/`` files and on the reference's
fixtures, each torch rule has a caught and a clean case on inline
sources, and the live tree is clean.
"""

import glob
import os

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CARRIED = {"PY-MUT-DEFAULT", "PY-DICT-MUT", "PY-SWALLOW"}
PORT_FILES = [(p, serving) for p, serving in lint.tree_files(ROOT)]
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                         "analysis", "*.py")))


def _carried(fs):
    return {(f.rule, f.line) for f in fs if f.rule in CARRIED}


@pytest.mark.parametrize("path,serving", PORT_FILES + [
    (p, s) for p in FIXTURES for s in (True, False)],
    ids=lambda x: os.path.relpath(x, ROOT) if isinstance(x, str) else
    ("serving" if x else "other"))
def test_carried_rules_match_reference(path, serving):
    got = lint.lint_file(path, serving=serving)
    want = ref_lint.lint_file(path, serving=serving)
    assert _carried(got) == _carried(want)
    assert [f.suppressed for f in sorted(got, key=lambda f: (f.line, f.rule))
            if f.rule in CARRIED] == [
        f.suppressed for f in sorted(want, key=lambda f: (f.line, f.rule))
        if f.rule in CARRIED]


def test_fixtures_exercise_the_carried_rules():
    found = set()
    for p in FIXTURES:
        found |= {f.rule for f in lint.lint_file(p, serving=True)}
    assert CARRIED <= found


def _lint(src, serving=True, path="src/repro_torch/serving/x.py"):
    return sorted((f.rule, f.line) for f in lint.lint_file(
        path, serving=serving, source=src) if not f.suppressed)


def test_pk_fresh_caught_in_a_serving_loop_only():
    src = ("import torch\n"
           "def loop(steps):\n"
           "    for _ in range(steps):\n"
           "        g = torch.Generator()\n"
           "        torch.manual_seed(0)\n"
           "def once(seed):\n"
           "    g = torch.Generator()\n"
           "    return g.manual_seed(seed)\n")
    assert _lint(src) == [("PK-FRESH", 4), ("PK-FRESH", 5)]
    assert _lint(src, serving=False, path="src/repro_torch/models/x.py") == []


def test_pk_split_caught_on_stateful_draws_clean_on_the_fold():
    src = ("import torch\n"
           "from repro_torch.serving import engine\n"
           "def loop(logits, uids, counts, steps, gen):\n"
           "    for i in range(steps):\n"
           "        u = torch.rand(4, generator=gen)\n"
           "        logits.uniform_()\n"
           "        t = torch.multinomial(logits, 1)\n"
           "        n = engine._slot_noise(0, uids, counts + i, 8)\n"
           "    return torch.randn(4)\n")
    assert _lint(src) == [("PK-SPLIT", 5), ("PK-SPLIT", 6), ("PK-SPLIT", 7)]


def test_pk_reuse_caught_and_clean():
    src = ("import torch\n"
           "def two_generators(seed):\n"
           "    a = torch.Generator().manual_seed(seed)\n"
           "    b = torch.Generator().manual_seed(seed)\n"
           "def rebound(seed):\n"
           "    a = torch.Generator().manual_seed(seed)\n"
           "    seed = seed + 1\n"
           "    b = torch.Generator().manual_seed(seed)\n"
           "def same_fold(seed, uids, counts):\n"
           "    a = _slot_noise(seed, uids, counts, 8)\n"
           "    b = _slot_noise(seed, uids, counts, 8)\n"
           "def next_index(seed, uids, counts, nxt):\n"
           "    a = _slot_noise(seed, uids, counts, 8)\n"
           "    b = _slot_noise(seed, uids, nxt, 8)\n")
    assert _lint(src, serving=False) == [("PK-REUSE", 4), ("PK-REUSE", 11)]


def test_py_traced_branch_caught_static_predicates_exempt():
    src = ("import torch\n"
           "def f(x, t):\n"
           "    if torch.any(x > 0):\n"
           "        pass\n"
           "    while torch.isfinite(x).all():\n"
           "        pass\n"
           "    if x.dtype == torch.bfloat16 and torch.cuda.is_available():\n"
           "        pass\n"
           "    if isinstance(t, torch.Tensor) or torch.is_tensor(x):\n"
           "        pass\n"
           "    if x.device == torch.device('cpu'):\n"
           "        pass\n")
    assert _lint(src, serving=False) == [("PY-TRACED-BRANCH", 3),
                                         ("PY-TRACED-BRANCH", 5)]


STEP = "src/repro_torch/serving/step.py"


def test_ob_sync_caught_and_clean():
    src = ("import torch\n"
           "class S:\n"
           "    def _decode_step(self):\n"
           "        tok = self.tok.cpu()\n"
           "        return tok.tolist()\n"
           "    def decode(self):\n"
           "        tok = self._decode_step()\n"
           "        n = tok.sum().item()\n"
           "        torch.cuda.synchronize()\n"
           "        torch.cuda.synchronize()  # repro: profiling-fence\n"
           "        torch.cuda.synchronize()  # repro: ignore[OB-SYNC]\n"
           "        return tok.cpu().numpy()\n")
    assert _lint(src, path=STEP) == [("OB-SYNC", 4), ("OB-SYNC", 5),
                                     ("OB-SYNC", 8), ("OB-SYNC", 9)]
    assert _lint(src) == []            # another serving file


def test_ob_sync_caught_in_a_copy_of_the_step_module():
    """The acceptance's injected fault: a ``.item()`` in ``_decode_step``."""
    src = open(os.path.join(ROOT, STEP)).read()
    anchor = "        ok = torch.isfinite(logits).all(dim=-1)\n"
    assert anchor in src[src.index("def _decode_step"):]
    bad = src.replace(anchor, anchor + "        ok.sum().item()\n", 1)
    line = bad[:bad.index("ok.sum().item()")].count("\n") + 1
    assert _lint(src, path=STEP) == []
    assert _lint(bad, path=STEP) == [("OB-SYNC", line)]


def test_live_tree_is_clean():
    fs = lint.lint_tree(ROOT)
    assert [f.render() for f in fs if not f.suppressed] == []
    # the pre-capture synchronise, annotated with its reason
    assert [(f.rule, f.path) for f in fs] == [("OB-SYNC", STEP)]
