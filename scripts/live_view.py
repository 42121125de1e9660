#!/usr/bin/env python
"""Live terminal viewer over the SLAM metrics stream.

The observability surface the reference puts in a Pangolin GL window
(reference: Src/DisplayHandler/*, declared GUI layer — SURVEY.md §1 L8):
here it is a zero-dependency ANSI dashboard that *follows* the JSONL
metrics stream written by `SLAMSystem(metrics_path=...)` (and
`scripts/run_sequence.py --metrics`), so the viewer runs out-of-process —
including on a workstation tailing a file the GPU host is writing — and
costs the pipeline nothing.

Shows: a braille top-down (X–Z) trajectory map with keyframe and
relocalization markers, frame/KF counters, live fps, coarse-tracker and
BA rmse sparklines, window point counts, and KF latency.

Usage:
    python scripts/live_view.py run.metrics.jsonl          # follow live
    python scripts/live_view.py run.metrics.jsonl --once   # one render
"""
from __future__ import annotations

import argparse
import json
import sys
import time

SPARK = "▁▂▃▄▅▆▇█"


class Dashboard:
    """Incremental state folded from metric records; renders ANSI frames."""

    def __init__(self, plot_w: int = 64, plot_h: int = 16):
        self.plot_w, self.plot_h = plot_w, plot_h
        self.traj = []            # (x, z, is_kf, reloc)
        self.rmse = []            # coarse tracker rmse per frame
        self.ba_rmse = []         # per keyframe
        self.lat = []             # KF latency ms
        self.n_frames = 0
        self.n_kf = 0
        self.n_reloc = 0
        self.n_active = 0
        self.n_ind = 0
        self.t_wall = []          # host arrival times for live fps

    def feed(self, rec: dict):
        if rec.get("t") == "frame":
            self.n_frames += 1
            self.t_wall.append(time.perf_counter())
            if len(self.t_wall) > 64:
                self.t_wall.pop(0)
            if "p" in rec:
                self.traj.append((rec["p"][0], rec["p"][2],
                                  bool(rec.get("kf")),
                                  bool(rec.get("reloc"))))
            r = rec.get("rmse")
            if r is not None and r == r and r < 1e9:
                self.rmse.append(r)
            self.n_reloc += bool(rec.get("reloc"))
        elif rec.get("t") == "kf":
            self.n_kf += 1
            self.n_active = rec.get("n_active", self.n_active)
            self.n_ind = rec.get("n_ind", self.n_ind)
            if "ba_rmse" in rec:
                self.ba_rmse.append(rec["ba_rmse"])
            if "latency_ms" in rec:
                self.lat.append(rec["latency_ms"])

    # ---------------------------------------------------------- rendering

    def _braille_map(self) -> list:
        """Top-down trajectory on a 2x4-dot-per-cell braille canvas."""
        W, H = self.plot_w, self.plot_h
        grid = [[0] * W for _ in range(H)]       # braille dot bitmasks
        marks = {}                                # (cy, cx) -> char overlay
        if self.traj:
            xs = [p[0] for p in self.traj]
            zs = [p[1] for p in self.traj]
            x0, x1 = min(xs), max(xs)
            z0, z1 = min(zs), max(zs)
            sx = (x1 - x0) or 1e-9
            sz = (z1 - z0) or 1e-9
            # braille cell = 2 dots wide, 4 tall
            DOT = ((0x01, 0x08), (0x02, 0x10), (0x04, 0x20), (0x40, 0x80))
            for x, z, is_kf, reloc in self.traj:
                px = (x - x0) / sx * (2 * W - 1)
                pz = (z - z0) / sz * (4 * H - 1)
                cx, dx = int(px) // 2, int(px) % 2
                cy, dy = int(pz) // 4, int(pz) % 4
                grid[cy][cx] |= DOT[dy][dx]
                if reloc:
                    marks[(cy, cx)] = "R"
                elif is_kf and (cy, cx) not in marks:
                    marks[(cy, cx)] = "□"
            # current position marker
            x, z = self.traj[-1][0], self.traj[-1][1]
            cy = int((z - z0) / sz * (4 * H - 1)) // 4
            cx = int((x - x0) / sx * (2 * W - 1)) // 2
            marks[(cy, cx)] = "●"
        rows = []
        for cy in range(H):
            row = []
            for cx in range(W):
                m = marks.get((cy, cx))
                row.append(m if m else
                           (chr(0x2800 + grid[cy][cx]) if grid[cy][cx]
                            else " "))
            rows.append("".join(row))
        return rows

    @staticmethod
    def _spark(vals, n=48) -> str:
        if not vals:
            return ""
        v = vals[-n:]
        lo, hi = min(v), max(v)
        rng = (hi - lo) or 1e-9
        return "".join(SPARK[int((x - lo) / rng * 7)] for x in v)

    def fps(self) -> float:
        if len(self.t_wall) < 2:
            return 0.0
        dt = self.t_wall[-1] - self.t_wall[0]
        return (len(self.t_wall) - 1) / dt if dt > 0 else 0.0

    def render(self, show_fps: bool = True) -> str:
        fps = f"  {self.fps():5.1f} fps" if show_fps else ""
        lines = []
        lines.append(
            f" hslam_tpu  frames {self.n_frames:5d}  kf {self.n_kf:4d}  "
            f"reloc {self.n_reloc}  pts {self.n_active:5d}  "
            f"ind {self.n_ind:4d}{fps}")
        lines.append(" " + "─" * (self.plot_w + 1))
        for row in self._braille_map():
            lines.append(" │" + row)
        lines.append(" " + "─" * (self.plot_w + 1)
                     + " top-down X–Z  □ keyframe  R reloc  ● now")
        if self.rmse:
            lines.append(f" track rmse {self.rmse[-1]:8.3f} "
                         f"{self._spark(self.rmse)}")
        if self.ba_rmse:
            lines.append(f" BA rmse    {self.ba_rmse[-1]:8.3f} "
                         f"{self._spark(self.ba_rmse)}")
        if self.lat:
            lines.append(f" KF latency {self.lat[-1]:6.1f}ms "
                         f"{self._spark(self.lat)}")
        return "\n".join(lines)


def follow(path: str, once: bool = False, out=sys.stdout,
           poll: float = 0.2) -> Dashboard:
    """Tail the metrics JSONL, re-rendering on new records. With
    `once=True`, fold everything currently in the file and render one
    frame (no ANSI clears — used by tests and for snapshots)."""
    dash = Dashboard()
    with open(path) as f:
        while True:
            drew = False
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    dash.feed(json.loads(line))
                except json.JSONDecodeError:
                    continue  # partial trailing line of a live writer
                drew = True
            if once:
                # wall-clock arrival rate is meaningless for a cold replay
                out.write(dash.render(show_fps=False) + "\n")
                return dash
            if drew:
                out.write("\x1b[2J\x1b[H" + dash.render() + "\n")
                out.flush()
            time.sleep(poll)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("metrics", help="JSONL metrics file to follow")
    ap.add_argument("--once", action="store_true",
                    help="render a single frame from current contents")
    args = ap.parse_args()
    try:
        follow(args.metrics, once=args.once)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
