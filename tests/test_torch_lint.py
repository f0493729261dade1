"""vitax_torch.analysis.ast_lint and .concurrency against vitax's lints.

Lint parity: on the snippets of vitax's own lint tests (inlined here), the
port's tools give vitax's (code, line) findings for every code whose
meaning did not change (VTX100, VTX105-VTX109, VTX200-VTX203, VTX205).
The codes given a torch meaning (VTX101-VTX104, VTX204) each get a torch
case that fires and one that stays silent. The port itself (vitax_torch/
and chip_smoke.py) is clean under both tools, and the checkpoint writer's
close() joins its thread where the lint sees it.
"""

import os
import textwrap

import pytest

from vitax.analysis import ast_lint as jax_ast_lint
from vitax.analysis import concurrency as jax_concurrency
from vitax_torch.analysis import ast_lint, concurrency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAME_AST = {"VTX100", "VTX105", "VTX106", "VTX107", "VTX108", "VTX109"}
SAME_THREAD = {"VTX200", "VTX201", "VTX202", "VTX203", "VTX205"}


def _pairs(findings, codes):
    return sorted((f.code, f.line) for f in findings if f.code in codes)


def _codes(findings):
    return sorted(f.code for f in findings)


# --- the snippets of tests/test_analysis.py's AST-lint tests, and of the
# VTX106-VTX109 tests (test_control.py, test_snapshot.py, test_lint.py) ----

AST_SNIPPETS = [
    ("import jax\ndef f(x):\n    return jax.device_get(x)\n", "models/vit.py"),
    ("import jax, jax.numpy as jnp\ndef f(x):\n    y = jnp.sum(x).block_until_ready()\n"
     "    return float(jnp.mean(y))\n", "train/step.py"),
    ("import jax.numpy as jnp\ndef f(x):\n    return jnp.max(x).item()\n", "ops/attention.py"),
    ("def f(d):\n    return d.item()\n", "ops/attention.py"),
    ("import time\ndef loop(step_fn, batch):\n    t0 = time.time()\n    out = step_fn(batch)\n"
     "    dt = time.time() - t0\n    return out, dt\n", "train/loop.py"),
    ("import jax\ndef f():\n    return jax.devices()[0]\n", "serve/server.py"),
    ("def f(xs=[], m={}):\n    return xs, m\n", "data/loader.py"),
    ("import jax\ndef f():\n    return jax.devices()[0]  # vtx: ignore[VTX104] test needs the live device list\n",
     "serve/server.py"),
    ("import jax\ndef f():\n    return jax.devices()[0]  # vtx: ignore[VTX104]\n", "serve/server.py"),
    ("def f(xs=set()):\n    return xs\n", "x.py"),
    ("def f():\n    try:\n        g()\n    except Exception:\n        pass\n    try:\n        g()\n"
     "    except:\n        ...\n    try:\n        g()\n    except (OSError, BaseException):\n        'ignored'\n",
     "x.py"),
    ("def f():\n    try:\n        g()\n    except OSError:\n        pass\n    try:\n        g()\n"
     "    except Exception as e:\n        log(e)\n", "x.py"),
    ("from vitax.train import preempt\ndef f(w):\n    if preempt.requested():\n        return 1\n"
     "    return w.escalation_requested()\n", "train/loop.py"),
    ("def f():\n    if preempt.requested():  # vtx: ignore[VTX107] sanctioned\n        return 1\n", "x.py"),
    ("def f(state):\n    for e in range(3):\n        save_state(state, e, wait=True)\n"
     "    save_state(state, 3, wait=True)\n", "train/loop.py"),
    ("import urllib.request, socket, http.client\ndef f(url):\n    urllib.request.urlopen(url)\n"
     "    socket.create_connection(('h', 1))\n    http.client.HTTPConnection('h', 1, 5.0)\n"
     "    urllib.request.urlopen(url, timeout=2)\n", "tools/x.py"),
    ("def f(xs=None):\n    return xs or []\n", "x.py"),
]


@pytest.mark.parametrize("src,sub", AST_SNIPPETS)
def test_ast_lint_matches_vitax_on_unchanged_codes(src, sub):
    mine = ast_lint.lint_source(src, f"vitax_torch/{sub}")
    theirs = jax_ast_lint.lint_source(src, f"vitax/{sub}")
    assert _pairs(mine, SAME_AST) == _pairs(theirs, SAME_AST)


def test_the_snippets_exercise_every_unchanged_code():
    seen = set()
    for src, sub in AST_SNIPPETS:
        seen |= {f.code for f in jax_ast_lint.lint_source(src, f"vitax/{sub}")}
    assert SAME_AST <= seen


# --- the torch meanings: VTX101-VTX104 ---------------------------------------

TORCH_CASES = [
    # (code, source, path, fires)
    ("VTX101", "def f(x):\n    return x.sum().item()\n", "vitax_torch/models/vit.py", True),
    ("VTX101", "import torch\ndef f(x):\n    torch.cuda.synchronize()\n    return x.cpu()\n",
     "vitax_torch/train/step.py", True),
    ("VTX101", "def f(x):\n    return x.sum().item()\n", "vitax_torch/telemetry/record.py", False),
    ("VTX101", "def f(x):\n    return x.sum()\n", "vitax_torch/ops/attention.py", False),
    ("VTX102", "import torch\ndef f(x):\n    return float(torch.linalg.vector_norm(x))\n",
     "vitax_torch/parallel/sharding.py", True),
    ("VTX102", "def f(shape):\n    return int(shape[0])\n", "vitax_torch/parallel/sharding.py", False),
    ("VTX103", "import time\ndef loop(step_fn, batch):\n    t0 = time.perf_counter()\n    out = step_fn(batch)\n"
               "    dt = time.perf_counter() - t0\n    return out, dt\n", "vitax_torch/train/loop.py", True),
    ("VTX103", "import time, torch\ndef loop(step_fn, batch):\n    t0 = time.perf_counter()\n"
               "    out = step_fn(batch)\n    torch.cuda.synchronize()\n    dt = time.perf_counter() - t0\n"
               "    return out, dt\n", "vitax_torch/train/loop.py", False),
    ("VTX103", "import time\ndef loop(step_fn, batch, end):\n    t0 = time.perf_counter()\n"
               "    out = step_fn(batch)\n    end.synchronize()\n    dt = time.perf_counter() - t0\n"
               "    return out, dt\n", "vitax_torch/train/loop.py", False),
    ("VTX104", "def f(x):\n    return x.cuda()\n", "vitax_torch/serve/engine.py", True),
    ("VTX104", "import torch\ndef f():\n    return torch.device('cuda')\n", "vitax_torch/serve/engine.py", True),
    ("VTX104", "import torch\ndef f(x):\n    return x.cuda(0), torch.device('cuda', 0), torch.device('cpu')\n",
     "vitax_torch/serve/engine.py", False),
    ("VTX104", "import torch\ndef resolve_device(device=None):\n    return torch.device('cuda')\n",
     "vitax_torch/platform.py", False),
]


@pytest.mark.parametrize("code,src,path,fires", TORCH_CASES)
def test_torch_meaning(code, src, path, fires):
    got = [f.code for f in ast_lint.lint_source(src, path)]
    assert (code in got) == fires, got


def test_torch_suppression_needs_a_reason():
    src = "def f(x):\n    return x.cuda()  # vtx: ignore[VTX104] one card\n"
    assert ast_lint.lint_source(src, "vitax_torch/x.py") == []
    bare = "def f(x):\n    return x.cuda()  # vtx: ignore[VTX104]\n"
    assert _codes(ast_lint.lint_source(bare, "vitax_torch/x.py")) == ["VTX100", "VTX104"]


# --- the thread lint: the snippets of tests/test_concurrency_lint.py ---------

THREAD_SNIPPETS = {
    "vtx200_firing": """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self._count = 0
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                self._count += 1

            def read(self):
                return self._count

            def stop(self):
                self._t.join(timeout=1.0)
    """,
    "vtx200_guarded": """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self._count = 0
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                with self._lock:
                    self._count += 1

            def read(self):
                with self._lock:
                    return self._count

            def stop(self):
                self._t.join(timeout=1.0)
    """,
    "vtx200_propagated": """
        import threading

        class Ctx:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _bump(self):
                self._n += 1

            def _run(self):
                with self._lock:
                    self._bump()

            def bump(self):
                with self._lock:
                    self._bump()

            def stop(self):
                self._t.join(timeout=1.0)
    """,
    "vtx201_firing": """
        import threading

        class Waiter:
            def __init__(self):
                self._cond = threading.Condition()
                self._ready = False

            def get(self):
                with self._cond:
                    if not self._ready:
                        self._cond.wait()
                    return self._ready
    """,
    "vtx201_while": """
        import threading

        class Waiter:
            def __init__(self):
                self._cond = threading.Condition()
                self._ready = False

            def get(self):
                with self._cond:
                    while not self._ready:
                        self._cond.wait(timeout=1.0)
                    return self._ready
    """,
    "vtx202_firing": """
        import threading

        class TwoLocks:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def _take_a(self):
                with self._a:
                    pass

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._b:
                    self._take_a()
    """,
    "vtx203_firing": """
        import queue
        import threading

        class Joiner:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue()
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                pass

            def drain_one(self):
                with self._lock:
                    return self._q.get()

            def stop(self):
                with self._lock:
                    self._t.join()
    """,
    "vtx204_jax": """
        import threading
        import jax

        class Dispatcher:
            def __init__(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                jax.device_put(1)

            def stop(self):
                self._t.join(timeout=1.0)
    """,
    "vtx205_firing": """
        import threading

        class Leaker:
            def start(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                pass

        def fire_and_forget(fn):
            threading.Thread(target=fn).start()
    """,
    "vtx205_silent": """
        import threading

        class Evented:
            def start(self):
                self._stop = threading.Event()
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                while not self._stop.wait(0.1):
                    pass

            def shutdown(self):
                self._stop.set()

        def run_and_wait(fn):
            t = threading.Thread(target=fn)
            t.start()
            t.join(timeout=5.0)
    """,
}


@pytest.mark.parametrize("name", sorted(THREAD_SNIPPETS))
def test_thread_lint_matches_vitax_on_unchanged_codes(name):
    src = textwrap.dedent(THREAD_SNIPPETS[name])
    mine = concurrency.lint_source(src, "fixture.py")
    theirs = jax_concurrency.lint_source(src, "fixture.py")
    assert _pairs(mine, SAME_THREAD) == _pairs(theirs, SAME_THREAD)
    if name.endswith("firing"):
        assert _pairs(mine, SAME_THREAD)


TORCH_THREAD = """
    import threading
    import torch

    class Copier:
        def __init__(self, buf, device):
            self.buf, self.device = buf, device
            self._t = threading.Thread(target=self._run)
            self._t.start()

        def _run(self):
            {body}

        def stage(self, x):
            return x.to(self.device, non_blocking=True)

        def stop(self):
            self._t.join(timeout=1.0)
"""


@pytest.mark.parametrize("body,fires", [
    ("torch.ones(4)", True),
    ("self.buf.to(self.device, non_blocking=True)", True),
    ("self.buf.copy_(self.buf)", True),
    ("self.buf.to(self.device)  # vtx: ignore[VTX204] the sanctioned copy thread", False),
    ("print(len(self.buf))", False),
])
def test_vtx204_is_device_work_on_a_thread(body, fires):
    src = textwrap.dedent(TORCH_THREAD).replace("{body}", body)
    got = [f.code for f in concurrency.lint_source(src, "fixture.py")]
    assert ("VTX204" in got) == fires, got


# --- the port is clean ------------------------------------------------------

def test_the_port_is_clean_under_both_lints():
    paths = [os.path.join(REPO, "vitax_torch"), os.path.join(REPO, "chip_smoke.py")]
    assert ast_lint.main(paths) == 0
    assert concurrency.main(paths) == 0


def test_port_cli_exit_codes(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text("def f(xs=[]):\n    return xs\n")
    assert ast_lint.main([str(bad)]) == 1
    assert ast_lint.main([str(bad), "--json"]) == 1
    good = tmp_path / "ok.py"
    good.write_text("def f(xs=None):\n    return xs or []\n")
    assert ast_lint.main([str(good)]) == 0
    leak = tmp_path / "leak.py"
    leak.write_text(textwrap.dedent(THREAD_SNIPPETS["vtx205_firing"]))
    assert concurrency.main([str(leak)]) == 1
    assert concurrency.main([str(good)]) == 0


def test_checkpoint_writer_close_joins_its_thread():
    from vitax_torch.checkpoint import io as ckpt_io
    writer = ckpt_io._Writer()
    done = []
    writer.submit(lambda: done.append(1))
    thread = writer._thread
    assert thread is not None and thread.is_alive()
    writer.close()
    assert done == [1] and not thread.is_alive() and writer._thread is None
