"""Collective bytes and FLOPs per device of SMOKE dry-run cells on a 2 x 2
(``data``, ``model``) mesh: the port's sharded step against the JAX
package's compiled one.

Usage:
  PYTHONPATH=src python tools/torch_collective_compare.py
      [--arch A ...] [--cell C ...] [--nothing]

Each package runs in a subprocess of its own, the two side by side:

* the port: ``repro_torch.launch.dryrun.run_cell`` as rank 0 of a
  ``fake`` process group of 4 ranks (every tensor on ``meta``);
* the reference: ``repro.launch.dryrun.run_cell`` on 4 host devices.

Both at 8 microbatches under the "dots" remat policy; ``--nothing``
adds the first arch's train_4k cell under "nothing" (FLOPs only).

The reference's bytes are read two ways. ``coll`` is what its
``run_cell`` reports: its HLO parser over the CPU backend's optimized
module, where XLA has promoted every bf16 collective to f32 (the CPU
passes ``all-reduce-promotion`` and ``float-normalization-bf16``; a TPU
or GPU compile keeps them in bf16). ``coll_own`` is the same module with
each collective's elements at the dtype they had before those passes:
the module dumped just before ``all-reduce-promotion`` gives each
collective's dtypes, and the wire bytes are the reference's own
formulas (``repro.launch.roofline``) over the optimized module at those
dtypes. An instruction the optimized module keeps whole is found by its
channel id. One that XLA combined from several (a tuple of elements,
under the channel id of one of them) is split by its operands: its
elements are matched one by one, in order, to a run of the collectives
of its kind and replica groups, in channel order, that holds its channel
id and has the same shapes in turn (``split_combined``; every such run
must give the same dtypes). Where that fails, an element takes the dtype
that every collective of its kind, shape and group size had; where they
had both bf16 and f32 (XLA merged loops and combined out of channel
order), the elements of that kind, groups and shape take the dtypes in
the counts the pre-promotion module issued them, and the tool raises if
the counts disagree. The port's collectives run in the dtype of what
they carry, so ``coll_own`` is the like-for-like yardstick; the tool
prints both, and the JSON the reference's ``split`` and ``by_count``.

Prints one line a cell and, last, a JSON object {"port": {...}, "jax":
{...}} keyed by "arch/cell".
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
CELLS = ("train_4k", "prefill_32k", "decode_32k")
_PROMOTION = "all-reduce-promotion"


def _elements(shape_text: str) -> list[tuple[str, tuple]]:
    """(dtype, dims) of each element of an HLO result shape."""
    return [(dt, tuple(int(d) for d in dims.split(",") if d))
            for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", shape_text)]


def _channel(ins) -> int | None:
    m = re.search(r"channel_id=(\d+)", ins["rest"])
    return int(m.group(1)) if m else None


def _groups(ins) -> tuple | None:
    """The replica groups of a collective, each a tuple of device ids,
    from either form XLA prints: ``{{0,2},{1,3}}`` or the iota form
    ``[2,2]<=[2,2]T(1,0)``."""
    import numpy as np

    rest = ins["rest"]
    m = re.search(r"replica_groups=\{((?:\{[\d,]*\},?)*)\}", rest)
    if m:
        return tuple(tuple(int(x) for x in g.split(",") if x)
                     for g in re.findall(r"\{([\d,]*)\}", m.group(1)))
    m = re.search(r"replica_groups=\[([\d,]+)\]<=\[([\d,]+)\]"
                  r"(?:T\(([\d,]+)\))?", rest)
    if not m:
        return None
    shape, dims = ([int(x) for x in g.split(",")] for g in m.group(1, 2))
    ids = np.arange(int(np.prod(dims))).reshape(dims)
    if m.group(3):
        ids = ids.transpose([int(x) for x in m.group(3).split(",")])
    return tuple(map(tuple, ids.reshape(shape).tolist()))


def split_combined(ins, els, issued) -> list[str] | None:
    """The dtypes before promotion of the elements ``els`` of ``ins``, a
    collective XLA combined from several, from ``issued``: the
    pre-promotion collectives of its kind and replica groups, as
    (channel id, elements) in channel order. The combiner took a run of
    them in that order and gave the result one of their channel ids, so
    every run of as many elements that holds that channel and has the
    same shapes in turn is a candidate; the dtypes where all candidates
    agree, else None."""
    ch = _channel(ins)
    seq = [(c, e) for c, els_ in issued for e in els_]
    dims = [d for _t, d in els]
    found = set()
    for i in range(len(seq) - len(els) + 1):
        run = seq[i:i + len(els)]
        if ([e[1] for _c, e in run] == dims
                and any(c == ch for c, _e in run)):
            found.add(tuple(e[0] for _c, e in run))
    return list(found.pop()) if len(found) == 1 else None


def own_dtype_bytes(final_text: str, pre_text: str, devices: int) -> dict:
    """Collective wire bytes per device of the optimized module
    ``final_text`` with each collective's elements at the dtype that
    ``pre_text`` (the module before the CPU's promotion passes) gives
    them; {"bytes", "detail", "as_compiled", "split", "by_count"}
    (``as_compiled``: the same count at the final module's dtypes, equal
    to the reference's; ``split``: the combined instructions split by
    their operands; ``by_count``: the elements left to the shape's
    count, below)."""
    from repro.launch import roofline as R

    def collectives(text):
        mod = R.parse_hlo_module(text)
        mult = R.computation_multipliers(mod)
        for cname, instrs in mod["computations"].items():
            for ins in instrs:
                if ins["op"] in R.COLLECTIVE_OPS:
                    yield mult.get(cname, 1.0), ins

    dtypes: dict[tuple, set] = {}
    by_channel: dict[int, list] = {}
    issued: dict[tuple, list] = {}
    # (kind, replica groups, shape) -> {dtype: elements issued, each
    # counted as often as its computation runs}
    weight: dict[tuple, dict] = {}
    for m, ins in collectives(pre_text):
        g = R._group_size(ins["rest"], devices)
        els = _elements(ins["shape"])
        if _channel(ins) is not None:
            by_channel[_channel(ins)] = els
            issued.setdefault((ins["op"], _groups(ins)), []).append(
                (_channel(ins), els))
        for dt, dims in els:
            dtypes.setdefault((ins["op"], dims, g), set()).add(dt)
            w = weight.setdefault((ins["op"], _groups(ins), dims), {})
            w[dt] = w.get(dt, 0.0) + m
    for v in issued.values():
        v.sort(key=lambda ce: ce[0])
    out = {"bytes": 0.0, "detail": {}, "as_compiled": 0.0, "split": 0,
           "by_count": 0}

    def add(m, ins, dims, dt, own, share=1.0):
        elem = {"op": ins["op"], "rest": ins["rest"]}
        b = share * m * R.collective_wire_bytes(
            {**elem, "shape": f"{own}[{','.join(map(str, dims))}]"}, devices)
        out["bytes"] += b
        out["detail"][ins["op"]] = out["detail"].get(ins["op"], 0.0) + b
        out["as_compiled"] += share * m * R.collective_wire_bytes(
            {**elem, "shape": f"{dt}[{','.join(map(str, dims))}]"}, devices)

    taken: dict[tuple, dict] = {}  # weight of each key's elements placed
    left: dict[tuple, list] = {}  # each key's elements with no answer yet
    for m, ins in collectives(final_text):
        g = R._group_size(ins["rest"], devices)
        els = _elements(ins["shape"])
        # the same instruction before the passes, else the ones XLA
        # combined into it, else its kind, shape and group size
        same = by_channel.get(_channel(ins))
        was = None
        if same is not None and [d for _t, d in same] == [d for _t, d in els]:
            was = [t for t, _d in same]
        elif _channel(ins) is not None and len(els) > 1:
            was = split_combined(ins, els, issued.get(
                (ins["op"], _groups(ins)), []))
            out["split"] += was is not None
        for i, (dt, dims) in enumerate(els):
            key = (ins["op"], _groups(ins), dims)
            if was is not None:
                own = was[i]
            else:
                kinds = dtypes.get((ins["op"], dims, g), {dt})
                if "bf16" in kinds and len(kinds) > 1:
                    left.setdefault(key, []).append((m, ins, dims, dt))
                    continue
                own = "bf16" if "bf16" in kinds else dt
            t = taken.setdefault(key, {})
            t[own] = t.get(own, 0.0) + m
            add(m, ins, dims, dt, "bf16" if own == "bf16" else dt)
    # XLA merged loops and combined collectives out of channel order: an
    # element of a shape issued both in bf16 and in f32 takes the dtypes
    # of what the pre-promotion module issued of its kind, groups and
    # shape less what the elements above took, in proportion; exact
    # bytes wherever those counts agree
    for key, items in left.items():
        rest = {dt: w - taken.get(key, {}).get(dt, 0.0)
                for dt, w in weight.get(key, {}).items()}
        rest = {dt: w for dt, w in rest.items() if w > 0}
        n = sum(m for m, *_ in items)
        if abs(sum(rest.values()) - n) > 1e-6 * n:
            raise ValueError(f"{key[0]} {key[2]}: {n} elements left, the "
                             f"pre-promotion module issued {rest}")
        for m, ins, dims, dt in items:
            for own, w in rest.items():
                add(m, ins, dims, dt, "bf16" if own == "bf16" else dt,
                    share=w / n)
        out["by_count"] += len(items)
    return out


def _jax_side(cells, nothing, dump):
    import numpy as np

    import repro.launch.dryrun as D  # sets the host device count first
    import jax
    from jax.sharding import Mesh
    from repro.optim import OptConfig
    from repro.train import TrainConfig

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    tcfg = TrainConfig(microbatches=8, remat_policy="dots", opt=OptConfig())
    out = {}
    for arch, cell in cells:
        seen = set(glob.glob(os.path.join(dump, "*")))
        a = D.run_cell(arch, cell, mesh, "m22", smoke=True, tcfg=tcfg)
        new = set(glob.glob(os.path.join(dump, "*"))) - seen
        pre = [f for f in new if f.endswith(f"before_{_PROMOTION}.txt")]
        final = [f for f in new if f.endswith("cpu_after_optimizations.txt")]
        if len(pre) != 1 or len(final) != 1:
            raise RuntimeError(f"{arch} {cell}: expected one dumped module, "
                               f"got {sorted(new)}")
        with open(pre[0]) as f, open(final[0]) as g:
            own = own_dtype_bytes(g.read(), f.read(), 4)
        if abs(own["as_compiled"] - a["collective_bytes_per_device"]) > 1:
            raise RuntimeError(f"{arch} {cell}: the dumped module is not "
                               f"the one run_cell read")
        out[f"{arch}/{cell}"] = {
            "flops": a["flops_per_device"],
            "coll": a["collective_bytes_per_device"],
            "detail": a["collective_detail"],
            "coll_own": own["bytes"], "detail_own": own["detail"],
            "split": own["split"], "by_count": own["by_count"]}
    if nothing:
        arch = cells[0][0]
        out[f"{arch}/train_4k/nothing"] = {"flops": D.run_cell(
            arch, "train_4k", mesh, "m22", smoke=True,
            tcfg=TrainConfig(microbatches=8, opt=OptConfig())
        )["flops_per_device"]}
    return out


def _port_side(cells, nothing):
    from repro_torch.launch import dryrun as D
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig

    mesh = D.fake_mesh((2, 2), ("data", "model"))
    tcfg = TrainConfig(microbatches=8, remat_policy="dots", opt=OptConfig())
    out = {}
    for arch, cell in cells:
        a = D.run_cell(arch, cell, mesh, "m22", smoke=True, tcfg=tcfg)
        out[f"{arch}/{cell}"] = {"flops": a["flops_per_device"],
                                 "coll": a["collective_bytes_per_device"],
                                 "detail": a["collective_detail"]}
    if nothing:
        arch = cells[0][0]
        out[f"{arch}/train_4k/nothing"] = {"flops": D.run_cell(
            arch, "train_4k", mesh, "m22", smoke=True,
            tcfg=TrainConfig(microbatches=8, opt=OptConfig())
        )["flops_per_device"]}
    return out


def compare(archs, cells=CELLS, *, nothing=False, workdir=None):
    """(port, jax): each side's results by "arch/cell", the two
    subprocesses run side by side; ``workdir`` holds the reference's
    HLO dumps (a temporary directory, removed after, by default)."""
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="collective_compare_") as d:
            return compare(archs, cells, nothing=nothing, workdir=d)
    base = [sys.executable, os.path.abspath(__file__), "--arch", *archs,
            "--cell", *cells] + (["--nothing"] if nothing else [])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [SRC, ROOT, os.environ.get("PYTHONPATH", "")]))
    dump = os.path.join(workdir, "hlo")
    procs = {
        "port": subprocess.Popen(base + ["--side", "port"], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True),
        "jax": subprocess.Popen(
            base + ["--side", "jax", "--dump", dump],
            env=dict(env, XLA_FLAGS=f"--xla_dump_to={dump} "
                     f"--xla_dump_hlo_pass_re={_PROMOTION}"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    res = {}
    for side, p in procs.items():
        out, err = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"{side} side failed:\n{out}\n{err[-4000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        res[side] = json.loads(line[-1][len("RESULT "):])
    return res["port"], res["jax"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["qwen3-32b",
                                                  "mixtral-8x22b"])
    ap.add_argument("--cell", nargs="+", default=list(CELLS))
    ap.add_argument("--nothing", action="store_true")
    ap.add_argument("--side", choices=("port", "jax"), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cells = [(a, c) for a in args.arch for c in args.cell]
    if args.side == "jax":
        print("RESULT " + json.dumps(_jax_side(cells, args.nothing,
                                               args.dump)))
        return 0
    if args.side == "port":
        print("RESULT " + json.dumps(_port_side(cells, args.nothing)))
        return 0
    port, ref = compare(args.arch, args.cell, nothing=args.nothing)
    print(f"{'cell':28s} {'port B/dev':>12s} {'JAX own':>12s} "
          f"{'ratio':>6s} {'JAX compiled':>13s} {'ratio':>6s} "
          f"{'FLOPs gap':>9s}")
    for key in ref:
        if "coll" not in ref[key]:
            continue
        p, j = port[key], ref[key]
        print(f"{key:28s} {p['coll']:12.4e} {j['coll_own']:12.4e} "
              f"{p['coll'] / j['coll_own']:6.3f} {j['coll']:13.4e} "
              f"{p['coll'] / j['coll']:6.3f} "
              f"{(p['flops'] - j['flops']) / j['flops']:+9.4f}")
    print(json.dumps({"port": port, "jax": ref}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
