"""Reduce ``jax.profiler`` traces to device metrics.

``jax.profiler.trace`` writes an ``*.xplane.pb`` file per capture;
``jax.profiler.ProfileData`` reads it with nothing but JAX.  This module
turns one capture into the numbers the benchmark and PERF.md keep:

* ``aggregate``   — device time per op, most expensive first, per plane;
* ``device_busy`` — busy time (the union of op intervals) and the
  window it falls in, so idle share = 1 − busy / window;
* ``scope_times`` — device time of the ops under each ``jax.named_scope``
  the model code sets, found in the op's HLO metadata.

An op event is one that carries an ``hlo_op`` stat: on a GPU these are
the kernels on the ``/device:GPU:<n>`` planes' stream lines, on the CPU
the XLA thunks on the ``/host:CPU`` threads.  When a trace has device
planes only those count; a CPU-only trace counts its host op events.

CLI:
  python -m vae_captioning.utils.xplane <trace_dir|file.xplane.pb> \
      [--top N] [--plane SUBSTR]
"""

from __future__ import annotations

import collections
import glob
import os
import re
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple


class OpStats(
        collections.namedtuple("OpStats", ["name", "duration_ns", "count"])):
    @property
    def duration_ms(self) -> float:
        return self.duration_ns / 1e6


def resolve_trace_path(path: str) -> str:
    """Accept a trace dir (as passed to jax.profiler.trace) or a file."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                            recursive=True))
    if not hits:
        raise FileNotFoundError(f"no *.xplane.pb under {path}")
    return hits[-1]      # newest capture


def load_trace(path: str):
    """The capture as ``jax.profiler.ProfileData`` (planes, lines, events)."""
    from jax.profiler import ProfileData
    return ProfileData.from_file(resolve_trace_path(path))


def _stats(event) -> Dict[str, object]:
    return dict(event.stats)


def op_events(path: str, plane_filter: str = "",
              device_only: bool = True
              ) -> Iterator[Tuple[str, object, Dict[str, object]]]:
    """(plane name, event, stats) for every op event.  ``device_only``
    keeps the device planes when the trace has any."""
    planes = list(load_trace(path).planes)
    has_device = any(p.name.startswith("/device:") for p in planes)
    for plane in planes:
        if plane_filter and plane_filter not in plane.name:
            continue
        if device_only and has_device and not plane.name.startswith(
                "/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = _stats(ev)
                if "hlo_op" in st:
                    yield plane.name, ev, st


def aggregate(path: str, plane_filter: str = "",
              device_only: bool = True) -> Dict[str, List[OpStats]]:
    """Per plane, op events summed by name, most expensive first."""
    dur: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    cnt: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    for pname, ev, _ in op_events(path, plane_filter, device_only):
        dur[pname][ev.name] += ev.duration_ns
        cnt[pname][ev.name] += 1
    return {p: [OpStats(n, d, cnt[p][n]) for n, d in c.most_common()]
            for p, c in dur.items()}


def _union(intervals: Iterable[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_busy(path: str, plane_filter: str = "") -> Tuple[float, float]:
    """(busy ns, window ns) over the op events: busy is the union of
    their intervals on each plane, summed over planes; the window runs
    from the first op start to the last op end."""
    per_plane: Dict[str, list] = collections.defaultdict(list)
    for pname, ev, _ in op_events(path, plane_filter):
        per_plane[pname].append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not per_plane:
        return 0.0, 0.0
    busy = sum(_union(iv) for iv in per_plane.values())
    starts = [s for iv in per_plane.values() for s, _ in iv]
    ends = [e for iv in per_plane.values() for _, e in iv]
    return busy, (max(ends) - min(starts)) * len(per_plane)


def scope_times(path: str, scopes: Sequence[str],
                op_names: Dict[str, str] | None = None) -> Dict[str, float]:
    """Device ns of the op events under each named scope, forward and
    backward together.  An event is under ``scope`` when its op path — a
    string stat of the event, or via ``op_names`` (HLO instruction name →
    ``metadata.op_name``) its ``hlo_op`` or kernel name — has ``scope``
    as a component, bare or wrapped by a transform: ``.../scope/...``,
    ``.../jvp(scope)/...``, ``.../transpose(jvp(scope))/...``.
    Kernels a command buffer hides (library GEMMs report only the
    buffer) carry no op path; trace with command buffers off to
    attribute them."""
    pats = {s: re.compile(rf"(^|[/(\s]){re.escape(s)}\)*/") for s in scopes}
    out = {s: 0.0 for s in scopes}
    for _, ev, st in op_events(path):
        text = " ".join(str(v) for v in st.values() if isinstance(v, str))
        if op_names:
            # inside a command buffer the hlo_op stat names the buffer;
            # the kernel's own name is its fusion's name with "." → "_"
            text += " " + op_names.get(str(st.get("hlo_op")), "")
            text += " " + op_names.get(ev.name, "")
        for s, pat in pats.items():
            if pat.search(text):
                out[s] += ev.duration_ns
    return out


def hlo_op_names(hlo_text: str) -> Dict[str, str]:
    """HLO instruction name → its ``metadata={op_name=...}`` from the text
    of a compiled module (``jitted.lower(...).compile().as_text()``);
    each name also under its GPU kernel spelling ("." → "_")."""
    out = {}
    for line in hlo_text.splitlines():
        line = line.strip()
        if " = " not in line or 'op_name="' not in line:
            continue
        name = line.split(" = ", 1)[0].split()[-1].lstrip("%")
        op = line.split('op_name="', 1)[1].split('"', 1)[0]
        out[name] = op
        out.setdefault(name.replace(".", "_"), op)   # GPU kernel names
    return out


def format_report(stats: Dict[str, List[OpStats]], top: int = 20,
                  plane_filter: str = "") -> str:
    rows = []
    for pname, ops in stats.items():
        if plane_filter and plane_filter not in pname:
            continue
        total = sum(o.duration_ns for o in ops)
        rows.append(f"== {pname}: {len(ops)} distinct ops, "
                    f"Σ {total / 1e6:.3f} ms")
        for o in ops[:top]:
            rows.append(f"  {o.duration_ms:10.3f} ms  x{o.count:<6d} "
                        f"{o.name[:110]}")
    return "\n".join(rows)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Summarize a jax.profiler xplane trace by op cost")
    p.add_argument("trace", help="trace dir (jax.profiler.trace target) "
                                 "or one *.xplane.pb file")
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--plane", default="",
                   help="only planes whose name contains this substring "
                        "(e.g. GPU)")
    args = p.parse_args(argv)
    stats = aggregate(args.trace, args.plane)
    busy, window = device_busy(args.trace, args.plane)
    print(f"busy {busy / 1e6:.3f} ms of a {window / 1e6:.3f} ms window")
    print(format_report(stats, args.top))


if __name__ == "__main__":
    main()
