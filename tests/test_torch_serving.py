"""The port's serving engine against the JAX engine, its own oracle and its
launcher, plus the import rule of the port (no JAX, nothing of ``repro``).

The workload is ``tests/test_serving.py``'s: quantized ``qwen-7b-smoke``
at d_model 128, d_ff 256, vocab 512; 2 slots, max_len 64, chunk 16; eight
requests of 3-19 prompt tokens and 2-7 new tokens from
``default_rng(2)``."""

import ast
import pathlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path issues many ops on tiny tensors.  On a loaded
    machine (the suite runs test files in parallel) intra-op threads wait
    for each other far longer than the work takes, so these tests run the
    port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
OVERRIDES = dict(d_model=128, d_ff=256, vocab_size=512)


def _workload():
    rng = np.random.default_rng(2)
    return [(100 + i,
             rng.integers(0, 512, int(rng.integers(3, 20))).astype(np.int32),
             int(rng.integers(2, 8)))
            for i in range(8)]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config("qwen-7b", **OVERRIDES)
    jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                           "dense")
    tcfg = get_smoke_config("qwen-7b", **OVERRIDES)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def jax_streams(setup):
    jcfg, jparams, _, _ = setup
    engine = JaxEngine(jcfg, jparams, batch_size=2, max_len=64,
                       chunk_size=16)
    for rid, prompt, n in _workload():
        engine.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
    return {r.rid: r.output for r in engine.run()}


@pytest.fixture(scope="module")
def port_run(setup):
    _, _, tcfg, tparams = setup
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    device="cpu")
    for rid, prompt, n in _workload():
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    done = engine.run()
    return engine, done


def test_engine_streams_equal_jax_engine(port_run, jax_streams):
    engine, done = port_run
    assert done.drained and len(done) == 8
    assert {r.rid: r.output for r in done} == jax_streams
    assert engine.dispatches == engine.steps     # one dispatch per tick
    assert engine.mixed_ticks > 0


def test_engine_streams_equal_port_oracle(setup, port_run):
    _, _, tcfg, tparams = setup
    _, done = port_run
    for r in done:
        assert r.output == reference_decode(tcfg, tparams, r.prompt,
                                            r.max_new_tokens, max_len=64,
                                            device="cpu"), r.rid


def test_late_arrivals_and_sample_hook(setup):
    """Requests submitted mid-flight through the ``sample`` hook refill the
    slots; outputs still equal the oracle."""
    _, _, tcfg, tparams = setup
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    device="cpu")
    reqs = [Request(rid=rid, prompt=p, max_new_tokens=n)
            for rid, p, n in _workload()[:5]]
    for r in reqs[:3]:
        engine.submit(r)
    late = list(reqs[3:])

    def sample(row):
        if late:
            engine.submit(late.pop())
        return int(np.argmax(row))

    done = engine.run(sample=sample)
    assert len(done) == 5 and engine.slot_occupancy > 0.5
    for r in done:
        assert r.output == reference_decode(tcfg, tparams, r.prompt,
                                            r.max_new_tokens, max_len=64,
                                            device="cpu")


def test_engine_stop_rules_and_admission(setup):
    """Prompt of exactly max_len: one token (no room to decode); a prompt
    past max_len is refused at submit; eos stops a stream."""
    _, _, tcfg, tparams = setup
    engine = Engine(tcfg, tparams, batch_size=2, max_len=16, chunk_size=8,
                    device="cpu")
    rng = np.random.default_rng(9)
    full = Request(rid=0, prompt=rng.integers(0, 512, 16), max_new_tokens=5)
    part = Request(rid=1, prompt=rng.integers(0, 512, 10),
                   max_new_tokens=100)
    engine.submit(full)
    engine.submit(part)
    done = engine.run()
    assert len(full.output) == 1 and len(part.output) == 16 - 10 + 1
    assert len(done) == 2
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        engine.submit(Request(rid=2, prompt=np.zeros(17, np.int32)))
    eos = part.output[2]
    engine = Engine(tcfg, tparams, batch_size=1, max_len=16, chunk_size=8,
                    eos_id=eos, device="cpu")
    again = Request(rid=3, prompt=part.prompt, max_new_tokens=100)
    engine.submit(again)
    engine.run()
    assert again.output == part.output[:part.output.index(eos) + 1]


def test_engine_refuses_unported_configs(setup):
    """A family the port does not serve yet is refused on any device; a
    page size the paged kernel does not take (8 to 128 tokens) is refused
    for a CUDA engine before anything is allocated, while the CPU's plain
    version serves it."""
    _, _, tcfg, tparams = setup
    import dataclasses
    with pytest.raises(NotImplementedError, match="not ported"):
        Engine(dataclasses.replace(tcfg, family="diffusion"), tparams,
               device="cpu")
    for bs in (4, 129):
        cfg = dataclasses.replace(tcfg, kv_layout="paged", kv_block_size=bs)
        with pytest.raises(NotImplementedError, match="pages of 8 to 128"):
            Engine(cfg, tparams, device="cuda")
    Engine(dataclasses.replace(tcfg, kv_layout="paged", kv_block_size=4),
           tparams, device="cpu")


@pytest.mark.parametrize("package", ["port", "jax"])
def test_duplicate_live_rid_is_refused(setup, package):
    """A rid already queued or running is refused at ``submit`` by both
    engines; once its request has finished the rid is accepted again."""
    jcfg, jparams, tcfg, tparams = setup
    if package == "port":
        engine = Engine(tcfg, tparams, batch_size=2, max_len=64,
                        chunk_size=16, device="cpu")
        make = Request
    else:
        engine = JaxEngine(jcfg, jparams, batch_size=2, max_len=64,
                           chunk_size=16)
        make = JaxRequest
    _, prompt, _ = _workload()[0]
    engine.submit(make(rid=7, prompt=prompt, max_new_tokens=3))
    with pytest.raises(ValueError, match="already queued or in flight"):
        engine.submit(make(rid=7, prompt=prompt, max_new_tokens=3))
    with warnings.catch_warnings():          # the JAX engine warns
        warnings.simplefilter("ignore", RuntimeWarning)
        engine.run(max_steps=1)              # rid 7 is running now
    with pytest.raises(ValueError, match="already queued or in flight"):
        engine.submit(make(rid=7, prompt=prompt, max_new_tokens=3))
    first = engine.run()
    assert [r.rid for r in first] == [7]
    again = make(rid=7, prompt=prompt, max_new_tokens=3)
    engine.submit(again)
    assert engine.run()[0] is again and again.output == first[0].output


def test_launcher_runs_on_cpu(capsys):
    serve.main(["--device", "cpu", "--requests", "3",
                "--max-new-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "strategy=dense device=cpu" in out
    assert "'completed': 3" in out
    assert "scheduler:" in out and "kernel launches:" in out


def test_launcher_serves_a_sparse_strategy_on_cpu(capsys):
    serve.main(["--device", "cpu", "--strategy", "strategy2", "--requests",
                "2", "--max-new-tokens", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert "strategy=strategy2 device=cpu" in out
    assert "'completed': 2" in out


def test_launcher_speculates_and_shares_on_cpu(capsys):
    """``--spec --prefix-cache --kv-layout paged``: the speculation and
    prefix-cache lines, with drafts scored and the system prompt hit."""
    serve.main(["--device", "cpu", "--spec", "--prefix-cache",
                "--kv-layout", "paged", "--requests", "6",
                "--max-new-tokens", "6", "--batch", "2"])
    out = capsys.readouterr().out
    assert "'completed': 6" in out and "NOT drained" not in out
    spec = next(ln for ln in out.splitlines()
                if ln.startswith("speculation: K=4 drafter=plookup"))
    assert "drafts accepted" in spec and "verify ticks" in spec
    line = next(ln for ln in out.splitlines()
                if ln.startswith("prefix cache:"))
    assert not line.startswith("prefix cache: 0 hits")


def test_launcher_takes_the_lifecycle_and_chaos_flags(capsys):
    """``--max-preemptions --audit-every --priority --deadline-s --chaos``
    with its seed and rates on a small paged pool: every request ends in a
    terminal state, the resilience line counts the preemptions, the
    quarantined rows and one audit a tick, and the chaos counters ride
    along."""
    serve.main(["--device", "cpu", "--kv-layout", "paged",
                "--kv-block-size", "8", "--kv-pool-blocks", "12",
                "--requests", "6", "--max-new-tokens", "6", "--batch", "3",
                "--max-preemptions", "2", "--audit-every", "1",
                "--priority", "1", "--deadline-s", "3600", "--chaos",
                "--chaos-seed", "3", "--chaos-deny-rate", "0.2",
                "--chaos-preempt-rate", "0.3", "--chaos-nan-rate", "0.05"])
    out = capsys.readouterr().out
    assert "NOT drained" not in out
    summary = next(ln for ln in out.splitlines() if ln.startswith("summary:"))
    assert "'n': 6" in summary and "'deadline_missed': 0" in summary
    line = next(ln for ln in out.splitlines()
                if ln.startswith("resilience:"))
    assert "(bound 2/req)" in line and "'seed': 3" in line
    assert "'nan_rate': 0.05" in line and "'preempt_rate': 0.3" in line
    ticks = int(out.split("scheduler: ")[1].split()[0])
    assert f"{ticks} audits" in line


def test_launcher_reports_the_fallbacks_on_the_xlstm(capsys):
    serve.main(["--device", "cpu", "--arch", "xlstm-1.3b", "--strategy",
                "none", "--spec", "--prefix-cache", "--requests", "2",
                "--max-new-tokens", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert ("speculation requested but family 'ssm' has no rewindable "
            "sequence dimension — plain decode fallback") in out
    assert ("prefix cache requested but family 'ssm' / layout 'slot' "
            "cannot share KV blocks — running without") in out
    assert "'completed': 2" in out and "speculation: K=" not in out


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.extend(sorted((ROOT / "tools").glob("*.py")))   # run on the card
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)} imports {mod}"
