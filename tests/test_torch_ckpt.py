"""The port's decode-state snapshots, restore-mode failover and request
journal, against the reference where the two meet: the RPCKPT v1 bytes
and the journal file.

``DecodeSnapshot.to_bytes`` must give the reference's bytes for the same
rows (the zip entries carry the clock's time, so both are written under
one frozen ``time.time``).  A bfloat16 row is stored as the reference
stores one, and the port reads the reference's bf16 snapshots back bit
for bit; the reference's own reader refuses them (ROADMAP queue C4).
"""
import json
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.chaos import ServerCrashed as JServerCrashed
from repro.configs.registry import get_config as jget_config
from repro.engine import QuantSpec as JSpec
from repro.serving import AsyncServer as JServer
from repro.serving import DecodeSnapshot as JSnapshot
from repro.serving import SnapshotError as JSnapshotError
from repro.serving import Tier as JTier
from repro.serving import loadgen as jloadgen
from repro.serving import replay_journal as jreplay
from repro.serving import resume_split as jresume_split
from repro_torch.configs.registry import get_config
from repro_torch.engine import QuantSpec
from repro_torch.serving import (AsyncServer, DecodeSnapshot,
                                 ServeEngine, ServeRequest, SnapshotError,
                                 Tier, loadgen, replay_journal,
                                 resume_split, validate_summary)
from repro_torch.serving.engine import state_leaves
from repro_torch.serving.scheduler import Scheduler

torch.set_num_threads(1)

BATCH = 2
MAX_LEN = 16
SCALE = 5e4
SPEC_TEXT = "planes=2,impl=pallas_fused,act_quant=per_token"
SPEC = QuantSpec.parse(SPEC_TEXT)


def _load(cfg, lg=loadgen, n=8, seed=0):
    return lg.synthesize(cfg.vocab_size, n, prompt_len=(3, 6),
                         max_tokens=(3, 6), pattern="poisson", rate=50,
                         deadline_slack=(0.1, 1.5), seed=seed)


@pytest.fixture(scope="module")
def cfg():
    return get_config("minicpm-2b", smoke=True)


@pytest.fixture(scope="module")
def params(cfg):
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.api import get_api
    return get_api(cfg).init(gen, cfg, torch.device("cpu"))


def _engine(cfg, params, **kw):
    return ServeEngine(cfg, BATCH, MAX_LEN, quant=SPEC, params=params,
                       device="cpu", **kw)


# ---------------------------------------------------------------------------
# RPCKPT v1 bytes
# ---------------------------------------------------------------------------

_FIELDS = dict(rid=7, spec="planes=2,encoding=ent,bits=8,impl=pallas_fused,"
               "act_quant=per_token", family="dense", max_len=16, pos=5,
               cursor=3, cur=42, prompt=[3, 1, 4, 1], out=[9, 42],
               arrival=0.25, admitted_at=0.5, first_token_at=0.75)


def _rows(dtype):
    rng = np.random.default_rng(3)
    f32 = [rng.standard_normal((2, 1, 16, 4, 16)).astype(np.float32)
           for _ in range(2)]
    if dtype == "float32":
        return f32, [torch.from_numpy(a.copy()) for a in f32]
    bf = [a.astype(ml_dtypes.bfloat16) for a in f32]
    return bf, [torch.from_numpy(a.view(np.int16).copy()).view(
        torch.bfloat16) for a in bf]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_bytes_equals_the_reference(dtype, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    jrows, trows = _rows(dtype)
    want = JSnapshot(rows=jrows, **_FIELDS).to_bytes()
    got = DecodeSnapshot(rows=trows, **_FIELDS).to_bytes()
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_reads_the_reference_bytes_bit_exactly(dtype):
    jrows, trows = _rows(dtype)
    snap = DecodeSnapshot.from_bytes(JSnapshot(rows=jrows,
                                               **_FIELDS).to_bytes())
    for got, want in zip(snap.rows, trows):
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == "bfloat16":
            got, want = got.view(torch.int16), want.view(torch.int16)
        assert torch.equal(got, want)
    assert (snap.rid, snap.pos, snap.out, snap.first_token_at) == \
        (7, 5, [9, 42], 0.75)


def test_reference_refuses_its_own_bf16_bytes():
    """ROADMAP queue C4: the reference writes a bf16 row under descr <V2
    and then compares the stored array's dtype (|V2) with the header's
    'bfloat16', so its real engine snapshots cannot be read back."""
    jrows, _ = _rows("bfloat16")
    data = JSnapshot(rows=jrows, **_FIELDS).to_bytes()
    with pytest.raises(JSnapshotError, match="does not match its stored"):
        JSnapshot.from_bytes(data)
    jrows, _ = _rows("float32")
    JSnapshot.from_bytes(JSnapshot(rows=jrows, **_FIELDS).to_bytes())


def test_corrupt_and_mismatched_rows_are_refused():
    _, trows = _rows("bfloat16")
    data = DecodeSnapshot(rows=trows, **_FIELDS).to_bytes()
    with pytest.raises(SnapshotError, match="checksum"):
        DecodeSnapshot.from_bytes(data[:-5] + bytes(5))
    with pytest.raises(SnapshotError, match="truncated"):
        DecodeSnapshot.from_bytes(data[:-5])
    # a header that says float16 over the raw two-byte payload (the same
    # header length: JSON whitespace pads it)
    head = data.replace(b'"dtype": "bfloat16"', b'"dtype": "float16" ')
    with pytest.raises(SnapshotError, match="does not match its stored"):
        DecodeSnapshot.from_bytes(head)


# ---------------------------------------------------------------------------
# engine seam: snapshot -> bytes -> restore into a fresh engine
# ---------------------------------------------------------------------------

def test_snapshot_restores_into_a_fresh_engine(cfg, params):
    prompt = [5, 3, 8, 2]
    ref = ServeRequest(0, list(prompt), 6)
    _engine(cfg, params).run([ref])

    eng1 = _engine(cfg, params)
    sched = Scheduler("fcfs", max_len=MAX_LEN)
    req = ServeRequest(0, list(prompt), 6)
    sched.submit(req, 0.0)
    eng1.admit_from(sched)
    while len(req.out) < 2:
        eng1.step()
    snap = eng1.snapshot_slot(0)
    assert snap.pos == len(prompt) + 1 and snap.cur == req.out[-1]
    assert [r.dtype for r in snap.rows] == [torch.bfloat16] * 2
    assert [tuple(r.shape) for r in snap.rows] == \
        [(cfg.n_layers, 1) + tuple(x.shape[2:])
         for x in state_leaves(eng1.state)]
    back = DecodeSnapshot.from_bytes(snap.to_bytes())

    eng2 = _engine(cfg, params)
    req2 = ServeRequest(0, list(prompt), 6, out=list(req.out))
    assert eng2.restorable(back) is None
    eng2.restore_slot(1, req2, back)
    steps = 0
    while not req2.done:
        eng2.step()
        steps += 1
    assert req2.out == ref.out
    assert steps == len(ref.out) - 2          # no re-prefill steps
    assert eng2.ckpt_stats["restored"] == 1
    assert eng2.ckpt_stats["reprefilled"] == 0
    for a, b in zip(state_leaves(eng1.state), state_leaves(eng2.state)):
        # the restored rows up to the snapshot's position are eng1's
        assert torch.equal(a[:, 0, :snap.pos].view(torch.int16),
                           b[:, 1, :snap.pos].view(torch.int16))


def test_restorable_refuses_another_spec(cfg, params):
    eng = _engine(cfg, params)
    sched = Scheduler("fcfs", max_len=MAX_LEN)
    req = ServeRequest(0, [1, 2, 3], 4)
    sched.submit(req, 0.0)
    eng.admit_from(sched)
    while not req.out:
        eng.step()
    snap = eng.snapshot_slot(0)
    other = ServeEngine(cfg, BATCH, MAX_LEN, params=params, device="cpu",
                        quant=SPEC.replace(planes=3))
    assert "spec mismatch" in other.restorable(snap)
    with pytest.raises(ValueError, match="not bound"):
        eng.snapshot_slot(1)


# ---------------------------------------------------------------------------
# twin-tier failover: kill at every pump index
# ---------------------------------------------------------------------------

def test_twin_tier_kill_at_every_pump_restores_token_exactly(cfg, params):
    tiers = (Tier("a", SPEC, BATCH), Tier("b", SPEC, BATCH))
    server = AsyncServer(cfg, tiers=tiers, max_len=MAX_LEN, router="slo",
                         step_time_scale=SCALE, retry_budget=4, audit=True,
                         params=params, device="cpu")
    healthy = _load(cfg, n=6)
    server.run(healthy)
    expect = {r.rid: list(r.out) for r in healthy}
    busy = max(server.workers, key=lambda n: server.workers[n].pumps)
    total = server.workers[busy].pumps
    assert total >= 3
    restored = 0
    for step in range(total):
        server.chaos = f"kill:{busy}@s{step}"
        marks = {n: len(w.engine.slots.trace)
                 for n, w in server.workers.items()}
        reqs = _load(cfg, n=6)
        stats = validate_summary(server.run(reqs))
        fo = stats["failover"]
        assert stats["completed"] == 6 and fo["lost"] == 0, step
        assert fo["worker_deaths"] == 1
        assert fo["restored"] == fo["snapshots"], step
        assert fo["reprefilled"] == 0 and fo["tokens_reprefilled"] == 0
        restored += fo["restored"]
        events = {}
        for n, w in server.workers.items():
            for ev in w.engine.slots.trace[marks[n]:]:
                events.setdefault(ev.rid, []).append(ev.pos)
        for r in reqs:
            assert r.out == expect[r.rid], (step, r.rid)
            gen = [p for p in events[r.rid] if p >= len(r.prompt) - 1]
            assert sorted(gen) == list(range(
                len(r.prompt) - 1, len(r.prompt) + len(r.out) - 1)), \
                (step, r.rid)                 # no token stepped twice
    assert restored > 0
    server.chaos = None


# ---------------------------------------------------------------------------
# the request journal
# ---------------------------------------------------------------------------

def test_reference_journal_replays_to_the_same_resume_split(tmp_path):
    """A journal the reference wrote (crash_server mid-run) replays in
    the port to the reference's replay and resume split."""
    jcfg = jget_config("minicpm-2b", smoke=True)
    spec = JSpec.parse("planes=2,impl=planes,act_quant=per_token")
    path = str(tmp_path / "serve.wal")
    srv = JServer(jcfg, tiers=(JTier("a", spec, BATCH),
                               JTier("b", spec, BATCH)),
                  max_len=MAX_LEN, seed=0, router="slo",
                  step_time_scale=SCALE, journal=path,
                  chaos="crash_server@s16")
    with pytest.raises(JServerCrashed):
        srv.run(_load(jcfg, jloadgen))
    srv.journal.close()
    jrep, trep = jreplay(path), replay_journal(path)
    for field in ("version", "seed", "records", "truncated", "admitted",
                  "committed", "completed", "dropped", "deaths"):
        if hasattr(jrep, field):
            assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.completed and trep.committed
    jserve, jout = jresume_split(jrep, _load(jcfg, jloadgen))
    tserve, tout = resume_split(trep, _load(get_config(
        "minicpm-2b", smoke=True)))
    assert tout == jout
    assert [(r.rid, r.out, r.first_token_at, r.state) for r in tserve] == \
        [(r.rid, r.out, r.first_token_at, r.state) for r in jserve]


def _launch(args, capsys):
    from repro_torch.launch import serve
    tier = f"--tier=a={SPEC_TEXT}"
    base = ["--smoke", "--device", "cpu", "--requests", "6",
            "--max-tokens", "5", "--arrival", "poisson", "--seed", "0",
            tier, tier.replace("a=", "b="), "--json"]
    rc = serve.main(base + args)
    capsys.readouterr()
    return rc


def test_crash_then_resume_through_the_launcher(tmp_path, capsys):
    full, resumed = tmp_path / "full.json", tmp_path / "resumed.json"
    wal = str(tmp_path / "serve.wal")
    assert _launch(["--outputs", str(full)], capsys) == 0
    assert _launch(["--journal", wal, "--chaos", "crash_server@s14"],
                   capsys) == 1
    rep = replay_journal(wal)
    assert rep.committed or rep.completed
    assert len(rep.completed) < 6
    assert _launch(["--journal", wal, "--resume", "--outputs",
                    str(resumed)], capsys) == 0
    want = json.loads(full.read_text())
    assert len(want) == 6
    assert json.loads(resumed.read_text()) == want
    assert {int(k): v for k, v in want.items()} == \
        replay_journal(wal).completed
