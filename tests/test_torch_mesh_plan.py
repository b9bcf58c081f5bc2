"""The mesh pass's plan and its order on the CPU.

A mesh pass on CUDA shards is one native call that walks the plan's table
(`ops.cuda.fused_estep.pass_schedule`, `_MeshPlan`); the walker needs the
card. Here the table is held to what the walk must guarantee: every
shard's launch of every block once, the fold on blocks after the first,
copies only for shards on another card, one re-add after the last block,
and each block's launches ordered after every launch of the block before
(streams and events replayed as a happens-before relation). A plan built
on CPU shards, its table interpreted with the plain per-block function,
gives `mesh_round`'s bits over passes in turn (the outputs used in turn),
also laid out as several cards. Plans are keyed by what shapes a pass,
live in a `mesh_plans` block (engine.fit holds one), and a fit's plans are
dropped at its end."""

import gc
import weakref

import numpy as np
import pytest
import torch

# Test workers share the CPU cores with each other and with JAX's own
# thread pool: one intra-op thread each keeps torch from oversubscribing.
torch.set_num_threads(1)

import harmonypy_tpu_torch as ht
from harmonypy_tpu_torch.ops.cuda import fused_estep as fe
from harmonypy_tpu_torch.ops.update_r_fused import (fused_update_block,
                                                    mesh_round)
from harmonypy_tpu_torch.parallel import sharding
from harmonypy_tpu_torch.parallel.mesh import make_mesh
from test_torch_mesh import FIT, _problem, _round_inputs


def _happens_before(ops, lead):
    """Per op index, the set of op indices ordered before it: each op runs
    on a stream (a launch on its shard's, the re-add and a block's
    all-gather on the lead card's current stream); a record takes its
    stream's history, a wait adds the event's."""
    hist, ev, before = {}, {}, []
    for i, op in enumerate(ops):
        kind = op[0]
        if kind == "launch":
            st = fe._stream(op[1], lead)
        elif kind in ("readd", "gather"):
            st = ("cur", lead)
        elif kind == "wait":
            st = op[1]
        else:
            st = op[2] if kind == "record" else op[1]
        h = hist.setdefault(st, set())
        if kind == "wait":
            h |= ev.get(op[2], set())
        before.append(set(h))
        h.add(i)
        if kind == "record":
            ev[op[1]] = set(h)
    return before, hist


LAYOUTS = [([0, 0, 0, 0], 4, False), ([0, 1, 2, 3], 3, False),
           ([0, 0, 1, 1], 5, False), ([0, 1], 2, True), ([0], 3, True),
           ([0, 0, 0, 0], 1, False)]


@pytest.mark.parametrize("cards,nb,multi", LAYOUTS)
@pytest.mark.parametrize("windowed", [False, True])
def test_pass_schedule_order(cards, nb, multi, windowed):
    """nb x S launches, each (shard, block) once, folding the re-add of
    the block before on b > 0 only; copies only for shards on another
    card (its inputs at block 0, the frame after); one re-add launch,
    after every launch of the last block; every launch of block b after
    every launch of block b - 1 and after the rows of block b - 1 reached
    the lead card; across processes one all-gather per block, after the
    block's join and before the next block's launches; at the end the
    current stream of every card ordered after its shards' work."""
    S, lead = len(cards), cards[0]
    ops = fe.pass_schedule(cards, nb, multi, [windowed] * S)
    before, hist = _happens_before(ops, lead)
    at = {}
    for i, op in enumerate(ops):
        if op[0] == "launch":
            assert (op[1], op[2]) not in at
            at[op[1], op[2]] = i
            assert op[3] == (op[2] > 0)
    assert sorted(at) == [(s, b) for s in range(S) for b in range(nb)]
    readd = [i for i, op in enumerate(ops) if op[0] == "readd"]
    assert len(readd) == 1 and ops[readd[0]][1] == nb - 1
    assert all(at[s, nb - 1] in before[readd[0]] for s in range(S))
    copies = [op for op in ops if op[0] == "copy"]
    remote = [s for s in range(S) if cards[s] != lead]
    assert all(op[1] == ("side", s) for op in copies
               for s in [op[1][1]]) and {op[1][1] for op in copies} == set(
                   remote)
    assert len(copies) == len(remote) * (len(fe.INPUTS) + 2 * nb - 1)
    rows_in = {}
    for i, op in enumerate(ops):
        if op[0] == "copy" and op[2][0] == "rows":
            rows_in[op[2][1], ops[i][2][2], sum(
                o[0] == "launch" and o[1] == op[2][1] for o in ops[:i]) - 1
            ] = i
    for (s, b), i in at.items():
        if b:
            assert all(at[t, b - 1] in before[i] for t in range(S))
            assert all(rows_in[t, (b - 1) & 1, b - 1] in before[i]
                       for t in remote)
    gathers = [i for i, op in enumerate(ops) if op[0] == "gather"]
    assert len(gathers) == (nb if multi else 0)
    for b, g in enumerate(gathers):
        assert all(at[s, b] in before[g] for s in range(S))
        assert all(g in before[at[s, b + 1]] for s in range(S)
                   if b + 1 < nb)
        assert g in before[readd[0]] or b < nb - 1
    zeros = [i for i, op in enumerate(ops) if op[0] == "zero"]
    assert len(zeros) == (S if windowed else 0)
    assert all(z in before[at[ops[z][2][1], 0]] for z in zeros)
    work = [i for i, op in enumerate(ops) if op[0] != "wait"]
    for c in set(cards):
        end = hist[("cur", c)]
        mine = [i for i in work if c == lead or (
            ops[i][0] == "launch" and cards[ops[i][1]] == c)]
        assert set(mine) <= end


def _readd_codes(flat, src_row, Or, Er, Pr_b, J_fix):
    """The kernels' frame re-add of one block from the rank codes (the
    per-block prologue's and the re-add kernel's), with frame_readd's
    operations in frame_readd's order."""
    acc = torch.zeros_like(flat[0])
    for r in range(J_fix):
        code = int(src_row[r])
        acc = acc + (flat[code] if code >= 0 else torch.zeros_like(acc))
    return Or + acc[:, 1:], Er + acc[:, 0:1] * Pr_b[None, :]


def _interpret(plan, v, fast, J_fix, scratch):
    """Walk a CPU plan's table as the native pass walks it on the card, a
    launch being the plain per-block function on the buffers its binding
    names (slots padded to the one-device width as mesh_round pads them on
    the CPU); scratch[s] holds shard s's (O1, E1) by block parity."""
    def T(sym):
        return plan.tensor(sym, v)
    K, B1 = plan.K, plan.B + 1
    for op in plan.schedule:
        kind = op[0]
        if kind == "copy":
            T(op[2]).copy_(T(op[3]))
        elif kind == "zero":
            T(op[2]).zero_()
        elif kind == "launch":
            s, b, readd = op[1:]
            bind, (O1, E1) = plan.binding[s], scratch[s]
            if readd:
                q = (b - 1) & 1
                frame = T(("frame", q) if plan.cards[s] == plan.cards[0]
                          else ("fcopy", s))
                O0, E0 = _readd_codes(frame.reshape(-1, K, B1),
                                      T(bind["src"])[b - 1], O1[q], E1[q],
                                      T(bind["Pr_b"]), J_fix)
            else:
                O0, E0 = T(bind["O"]), T(bind["E"])
            out = tuple(T(bind[n]) for n in ("cache", "ybuf", "kbuf"))
            slots = T(bind["slots"])
            J, nc1 = slots.shape[1], out[0].shape[0]
            pad = J_fix + 1 - J
            padded = torch.cat([slots, slots.new_full((slots.shape[0], pad),
                                                      nc1 - 1)], 1)
            rw = bind["rw"]
            Ob, Eb = fused_update_block(
                b, padded, T(bind["removal"]), T(bind["ZP3"]), T(bind["Y"]),
                T(bind["sigma"]), T(bind["theta"]), T(bind["Pr_b"]), O0, E0,
                fast, out, T(rw) if rw[0] == "Rw" else None, v["lo", s],
                T(rw) if rw[0] == "R3" else None)
            O1[b & 1], E1[b & 1] = Ob, Eb
            dst = (("rows", s, b & 1) if plan.cards[s] == plan.cards[0]
                   else ("brows", s))
            T(dst).copy_(out[0][slots[b].long()])
        elif kind == "readd":
            q = op[1] & 1
            O, E = _readd_codes(T(("frame", q)).reshape(-1, K, B1),
                                T(("in", "src"))[op[1]], scratch[0][0][q],
                                scratch[0][1][q], T(("in", "Pr_b")), J_fix)
            T(("out", "O")).copy_(O)
            T(("out", "E")).copy_(E)
        else:
            assert kind in ("record", "wait")
    out = plan.ring[plan.parity]
    return (out["OE"][0], out["OE"][1], [o[0] for o in out["out"]],
            [o[1] for o in out["out"]], [o[2] for o in out["out"]],
            list(plan.Rws))


@pytest.fixture(scope="module")
def data():
    return _problem()


@pytest.mark.parametrize("cards", [[0, 0, 0, 0], [0, 1, 0, 1],
                                   [0, 1, 2, 3]])
@pytest.mark.parametrize("kind", ["round", "r_window", "float32",
                                  "bfloat16"])
def test_plan_table_interpreted_equals_mesh_round(data, cards, kind):
    """Three passes in turn through one plan on four CPU shards (laid out
    as one card, two or four), each pass's inputs the outputs of the one
    before (as the engine's rounds chain them): every pass equals
    mesh_round bit for bit (O, E, the per-chunk rows, the r windows, the
    stored R), and the outputs of the pass before stay intact through the
    next pass."""
    X, meta = data
    g1, g, _, tabs, ZP3s, common = _round_inputs(4, X, meta)
    Y, sigma, theta, Pr_b, O, E = common
    fast = kind == "round"
    lo, width = 5, 9
    wins = ([(lo - s * g.nc_cap, width)
             if sharding.window_rows(g, s, lo, width)[2] else None
             for s in range(4)] if kind == "r_window" else None)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(kind)
    R3s = (None if dt is None else
           [torch.zeros((g.nc_cap + 1, 12, g.CH), dtype=dt)
            for _ in range(4)])
    ref_R3s = None if R3s is None else [r.clone() for r in R3s]
    plan = fe._MeshPlan(tabs, ZP3s, Y, sigma, theta, Pr_b, O, E, fast,
                        g.J_fix, wins, R3s, tabs.src, cards=cards)
    scratch = [(torch.zeros(2, *O.shape), torch.zeros(2, *O.shape))
               for _ in range(4)]
    prev = None
    for rep in range(3):
        ref = mesh_round(tabs, ZP3s, Y, sigma, theta, Pr_b, O, E, fast,
                         g.J_fix, wins, ref_R3s)
        kept = None if prev is None else [t.clone() for t in prev]
        v = plan.values(tabs, ZP3s, Y, sigma, theta, Pr_b, O, E, wins,
                        R3s, tabs.src)
        got = _interpret(plan, v, fast, g.J_fix, scratch)
        plan.parity ^= 1
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        for a, b in zip(got[2] + got[3] + got[4], ref[2] + ref[3] + ref[4]):
            assert torch.equal(a, b)
        for a, b in zip(got[5], ref[5]):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
        if R3s is not None:
            for a, b in zip(R3s, ref_R3s):
                assert torch.equal(a, b)
        if kept is not None:
            assert all(torch.equal(a, b) for a, b in zip(prev, kept))
        prev = [got[0], got[1], *got[2], *got[3], *got[4]]
        O, E = got[0], got[1]
        Y = torch.nn.functional.normalize(Y + 0.01 * rep, dim=0)


def test_plan_binds_every_symbol(data):
    """Every value the native walker reads is the plan's own buffer or one
    the pass writes in (its inputs, the output set in turn, the cards'
    current streams), and the plan's table encodes the schedule's ops but
    the all-gathers."""
    X, meta = data
    g1, g, _, tabs, ZP3s, common = _round_inputs(4, X, meta)
    plan = fe._MeshPlan(tabs, ZP3s, *common, False, g.J_fix, None, None,
                        tabs.src, cards=[0, 1, 1, 0])
    v = plan.values(tabs, ZP3s, *common, None, None, tabs.src)
    for sym in plan.index:
        assert sym in plan.fixed or sym in v or sym[0] == "side", sym
    assert len(plan.ops) == len(plan.schedule)
    assert [s[:3] for s in plan.segments] == [(0, len(plan.ops), False)]
    assert plan.segments[0][3:] == (4 * g.nb, 1)
    assert len(plan.events) == 1 + 2 + 3     # fork, start per card, done


def _key_args(tabs, ZP3s, common, J_fix):
    Y, sigma, theta, Pr_b, O, E = common
    return dict(tables=tabs, ZP3s=ZP3s, Y=Y, theta=theta, O=O,
                fast_ent=False, J_fix=J_fix)


def test_plan_key_changes_with_each_field_that_shapes_a_pass(data):
    """plan_key moves with the devices, the slabs (chunks, CH, d + B), the
    mesh's shard count, the blocks, the slots, J_fix, d, K, B, the
    objective form, the windows' widths, the R dtype and the precision
    (one plan never serves the other variant of the kernels); not with the
    values of the inputs."""
    X, meta = data
    g1, g, _, tabs, ZP3s, common = _round_inputs(4, X, meta)
    base = _key_args(tabs, ZP3s, common, g.J_fix)
    key = fe.plan_key(**base)
    Y, theta = common[0], common[2]
    changed = [
        dict(ZP3s=[z[:-1] for z in ZP3s]),
        dict(ZP3s=[z[..., :-4] for z in ZP3s]),
        dict(tables=tabs._replace(granks=tabs.granks + tabs.granks[:1])),
        dict(tables=tabs._replace(removal=tabs.removal[:-1])),
        dict(tables=tabs._replace(slots=[s[:, :-1] for s in tabs.slots])),
        dict(J_fix=g.J_fix + 1), dict(Y=Y[:-1]), dict(Y=Y[:, :-1]),
        dict(theta=theta[:-1]), dict(fast_ent=True),
        dict(windows=[(0, 9)] * 4), dict(windows=[(0, 8)] * 4),
        dict(windows=[(0, 9), None, None, None]),
        dict(R3s=[torch.zeros(1)] * 4),
        dict(R3s=[torch.zeros(1, dtype=torch.bfloat16)] * 4),
        dict(O=common[4].to("meta")),
        dict(precision="default"),
    ]
    keys = {key}
    for ch in changed:
        k = fe.plan_key(**{**base, **ch})
        assert k != key, ch
        keys.add(k)
    assert len(keys) == len(changed) + 1
    same = fe.plan_key(**{**base, "Y": torch.randn_like(Y),
                          "ZP3s": [z.clone() for z in ZP3s]})
    assert same == key
    assert fe.plan_key(**base, precision="float32") == key


def test_mesh_plans_block_keeps_and_drops_plans():
    """Inside a mesh_plans block plan_for makes a key's plan once and
    returns it after; nested blocks share the outer one; the plans go at
    the end of the outermost block, also when it raises; outside a block
    every call makes a new one."""
    made = []

    def make():
        made.append(object())
        return made[-1]
    assert fe.active_plans() == {}
    assert fe.plan_for("a", make) is not fe.plan_for("a", make)
    made.clear()
    with fe.mesh_plans():
        a = fe.plan_for("a", make)
        with fe.mesh_plans():
            assert fe.plan_for("a", make) is a
            b = fe.plan_for("b", make)
        assert fe.active_plans() == {"a": a, "b": b}
    assert fe.active_plans() == {} and len(made) == 2
    with pytest.raises(RuntimeError):
        with fe.mesh_plans():
            fe.plan_for("a", make)
            raise RuntimeError
    assert fe.active_plans() == {}


def _planned_mesh_pass(record):
    """fused_estep_mesh as it runs on CUDA shards, for CPU shards: a CPU
    plan looked up in the active block by plan_key (made on its first
    pass), then mesh_round; records (key, plan) of every pass."""
    def run(tables, ZP3s, Y, sigma, theta, Pr_b, O, E, fast_ent, J_fix,
            windows=None, R3s=None, precision="float32"):
        key = fe.plan_key(tables, ZP3s, Y, theta, O, fast_ent, J_fix,
                          windows, R3s, precision)
        plan = fe.plan_for(key, lambda: fe._MeshPlan(
            tables, ZP3s, Y, sigma, theta, Pr_b, O, E, fast_ent, J_fix,
            windows, R3s, tables.src, precision=precision))
        record.append((key, plan, dict(fe.active_plans())))
        return mesh_round(tables, ZP3s, Y, sigma, theta, Pr_b, O, E,
                          fast_ent, J_fix, windows, R3s)
    return run


@pytest.mark.parametrize("kw", [{}, dict(defer_r=False)])
def test_fit_plans_made_once_and_dropped_at_its_end(monkeypatch, data, kw):
    """A mesh fit's passes, planned as on the card: one plan per key
    (deferred: the round and the replays' window; stored: the round), made
    on its first pass and reused by every later pass of the fit, and none
    left once the fit returns (the plans are freed)."""
    X, meta = data
    record = []
    from harmonypy_tpu_torch import engine
    from harmonypy_tpu_torch.ops import replay
    for mod in (engine, replay):
        monkeypatch.setattr(mod, "fused_estep_mesh",
                            _planned_mesh_pass(record))
    ho = ht.run_harmony(X, meta, ["batch"], mesh=make_mesh(["cpu"] * 4),
                        **FIT, **kw)
    assert len(record) == ho.state.n_passes
    plans = {}
    for key, plan, active in record:
        assert plans.setdefault(key, plan) is plan
        assert active[key] is plan
    assert len(plans) == (2 if ho.cfg.defer_r else 1)
    assert fe.active_plans() == {}
    refs = [weakref.ref(p) for p in plans.values()]
    record.clear()
    del plans, plan, active
    gc.collect()
    assert all(r() is None for r in refs)


def test_fits_of_two_shapes_in_one_process_equal_each_alone(monkeypatch,
                                                            data):
    """Two mesh fits of different shapes in one process, planned as on the
    card, then the first again: each equals itself bitwise, and the second
    fit made its own plans (none of the first's is reused). The first fit's
    plans are kept alive until that is checked: a freed plan's address,
    and so its id(), can come back on a new plan."""
    X, meta = data
    record = []
    from harmonypy_tpu_torch import engine
    from harmonypy_tpu_torch.ops import replay
    for mod in (engine, replay):
        monkeypatch.setattr(mod, "fused_estep_mesh",
                            _planned_mesh_pass(record))
    mesh = make_mesh(["cpu"] * 4)
    a = ht.run_harmony(X, meta, ["batch"], mesh=mesh, **FIT)
    first = [p for _, p, _ in record]
    record.clear()
    b = ht.run_harmony(X[:4500, :6], meta.iloc[:4500], ["batch"], mesh=mesh,
                       **FIT)
    assert first and record
    assert not any(p is q for p in first for _, q, _ in record)
    del first
    a2 = ht.run_harmony(X, meta, ["batch"], mesh=mesh, **FIT)
    b2 = ht.run_harmony(X[:4500, :6], meta.iloc[:4500], ["batch"],
                        mesh=mesh, **FIT)
    for x, y in ((a, a2), (b, b2)):
        assert np.array_equal(x.Z_corr, y.Z_corr)
        assert np.array_equal(x.R, y.R)
        assert np.array_equal(x.objective_harmony, y.objective_harmony)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the native mesh pass has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_planned_passes_on_the_card_equal_unplanned(cuda_device, data):
    """Three passes through one plan on four logical shards of the card,
    chained as rounds: each equals the same pass made with a plan of its
    own (outside a mesh_plans block) bit for bit, with one native call and
    no allocation after the first."""
    X, meta = data
    g1, g, _, tabs, ZP3s, common = _round_inputs(4, X, meta)
    tabs = tabs._replace(slots=[s.to(cuda_device) for s in tabs.slots],
                         granks=[x.to(cuda_device) for x in tabs.granks],
                         removal=tabs.removal.to(cuda_device),
                         src=tabs.src.to(cuda_device))
    ZP3s = [z.to(cuda_device) for z in ZP3s]
    Y, sigma, theta, Pr_b, O0, E0 = (c.to(cuda_device) for c in common)

    def chain():
        O, E, outs = O0, E0, []
        for _ in range(3):
            n0 = fe.native_calls
            a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
            got = fe.fused_estep_mesh(tabs, ZP3s, Y, sigma, theta, Pr_b, O,
                                      E, False, g.J_fix)
            a1 = torch.cuda.memory_stats()["allocation.all.allocated"]
            assert fe.native_calls == n0 + 1
            outs.append(([t.clone() for t in (got[0], got[1], *got[2],
                                               *got[3], *got[4])], a1 - a0))
            O, E = got[0], got[1]
        return outs
    ref = chain()
    with fe.mesh_plans():
        got = chain()
    assert [n for _, n in got[1:]] == [0, 0]
    for (a, _), (b, _) in zip(got, ref):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
