"""Streaming watch-folder depth serving CLI (the port of the JAX
package's ``cli/serve.py``).

Watches a directory, batches new frames through ``DepthServingEngine`` on
the card (unless ``--device cpu``) and writes depth PNG/NPY outputs with
the conventions of ``cli/infer.py``. Frames are read by the port's PNG
and JPEG readers (``data.io.decode_rgb``); one that does not read (a
partial upload, a format the port does not take) is retried while it
changes and parked once it stops changing.

Usage:
    python -m ...cli.serve --encoder vitl --load-from ckpt --max-depth 20 \\
        -i incoming_frames/ -o depths/ [--batch-size 8] [--poll 0.5]
        [--once]  # process what's there and exit (no watching)

The speed dials ``--token-merge``, ``--int8`` and ``--int8-calib K`` act
as in the JAX package (``--int8-calib``: the engine calibrates static
scales on the first K batches of each resolution). ``--from-export
ARTIFACT`` replays a program saved by ``cli/export_model.py``, with the
weights of ``--load-from``: its traced-in dials win (a flag that
contradicts them exits with code 2), batches take the artifact's size,
and frames of another (H, W) are skipped with a message.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from ..data.io import decode_rgb
from . import add_speed_dials, check_speed_dials


class _ReadRetryTracker:
    """Decide when to stop re-reading a file that does not decode.

    A mid-upload partial file must be retried until it stops growing (a
    multi-MB scp can span many poll cycles); a genuinely corrupt file must
    not claim its output stem or burn a decode attempt every poll. Policy:
    after ``patience`` consecutive failed reads of a file whose
    (size, mtime) signature did not change between polls, PARK it: skip
    the decode (one cheap ``os.stat`` per poll instead) until the
    signature changes again (a stalled upload that later resumes is picked
    back up; a truly corrupt file costs nothing). Nothing is ever
    permanently dropped.
    """

    def __init__(self, patience: int = 3):
        self.patience = patience
        # path -> (consecutive failures of an unchanged file, signature)
        self._fails: dict[str, tuple[int, tuple[int, int]]] = {}

    def _sig(self, path: str):
        try:
            st = os.stat(path)
        except OSError:
            return None  # deleted mid-poll; drops out at the next scan
        return (st.st_size, st.st_mtime_ns)

    def note_failure(self, path: str) -> bool:
        """Record a failed read; True = just became stable-and-unreadable
        (fires once: the caller logs, then ``parked`` takes over)."""
        sig = self._sig(path)
        if sig is None:
            return False
        count, prev_sig = self._fails.get(path, (0, None))
        count = count + 1 if sig == prev_sig else 1
        self._fails[path] = (count, sig)
        return count == self.patience

    def parked(self, path: str) -> bool:
        """True = stable-and-unreadable at the recorded signature; skip
        the decode this poll. A changed signature un-parks the file."""
        count, prev_sig = self._fails.get(path, (0, None))
        if count < self.patience:
            return False
        sig = self._sig(path)
        if sig == prev_sig:
            return True
        self._fails.pop(path, None)  # resumed upload / rewrite: retry
        return False

    def clear(self, path: str) -> None:
        self._fails.pop(path, None)

    def prune(self, current: set[str]) -> None:
        self._fails = {p: v for p, v in self._fails.items() if p in current}


def _read_bgr(path: str) -> tuple[np.ndarray | None, str]:
    """(BGR uint8 frame, "") or (None, why it did not read)."""
    try:
        return np.ascontiguousarray(decode_rgb(path)[..., ::-1]), ""
    except (OSError, ValueError) as exc:
        return None, str(exc)


def main(argv=None) -> dict:
    """Run the CLI. Returns the frames ``served``, the paths left
    ``unread`` in the last poll (with why), and the engine's ``stats``."""
    from ..media.colormap import colorize_depth
    from ..media.imageio import write_png
    from ..models.convert import load_or_init_depth_model
    from ..serving.engine import DepthServingEngine

    p = argparse.ArgumentParser()
    p.add_argument("--encoder", default="vitl",
                   choices=["vits", "vitb", "vitl", "vitg", "vitt"])
    p.add_argument("--load-from", default=None)
    p.add_argument("--max-depth", type=float, default=20.0)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--outdir", required=True)
    p.add_argument("--input-size", type=int, default=518)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--poll", type=float, default=0.5,
                   help="directory poll interval (seconds)")
    p.add_argument("--once", action="store_true",
                   help="process the current directory contents and exit")
    p.add_argument("--from-export", default=None, metavar="ARTIFACT",
                   help="serve an exported program (cli/export_model.py) "
                        "instead of the live model; weights still come "
                        "from --load-from. Only frames matching the "
                        "exported (H, W) are served; others are skipped "
                        "with a message")
    p.add_argument("--save-numpy", action="store_true")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (default) or cpu")
    add_speed_dials(p)
    args = p.parse_args(argv)
    check_speed_dials(p, args)
    if args.int8_calib and args.from_export:
        p.error("--int8-calib does not apply to --from-export (bake the "
                "scales at export time: export_model --int8-calib)")

    model = load_or_init_depth_model(args.encoder, args.max_depth,
                                     args.load_from, device=args.device,
                                     token_merge=args.token_merge,
                                     quant_int8=args.int8)
    runner = export_hw = None
    if args.from_export:
        from ..serving.export import exported_runner, load_exported

        prog = load_exported(args.from_export)
        meta = prog.meta
        # The artifact's traced-in dials win: flags that contradict them
        # would serve another configuration than the one asked for.
        if args.int8 and not meta["quant_int8"]:
            p.error(f"--int8 contradicts the artifact "
                    f"(quant_int8={meta['quant_int8']}); the exported "
                    f"program's dials are fixed at export time")
        if args.token_merge and args.token_merge != meta["token_merge"]:
            p.error(f"--token-merge {args.token_merge} contradicts the "
                    f"artifact (token_merge={meta['token_merge']})")
        if args.input_size != 518 and args.input_size != meta["input_size"]:
            p.error(f"--input-size {args.input_size} contradicts the "
                    f"artifact (input_size={meta['input_size']})")
        if args.batch_size != meta["batch_size"]:
            print(f"[serve] note: batching to the artifact's batch size "
                  f"{meta['batch_size']} (not --batch-size "
                  f"{args.batch_size})")
            args.batch_size = int(meta["batch_size"])
        runner = exported_runner(prog, model.state_dict())
        export_hw = tuple(meta["frame_hw"])
        print(f"[serve] replaying exported program {args.from_export} "
              f"(frame {export_hw}, batch {meta['batch_size']}, "
              f"int8={meta['quant_int8']}, "
              f"token_merge={meta['token_merge']}, "
              f"platforms {meta['platforms']})")
    os.makedirs(args.outdir, exist_ok=True)
    processed: set[str] = set()
    stem_owner: dict[str, str] = {}  # guard a.png / a.jpg output collision
    retries = _ReadRetryTracker()
    served = 0
    unread: dict[str, str] = {}
    # Frames of another resolution under --from-export: parked by (size,
    # mtime) signature; an in-place rewrite un-parks them.
    res_skipped: dict[str, tuple[int, int]] = {}

    def res_parked(path: str) -> bool:
        sig = res_skipped.get(path)
        if sig is None:
            return False
        try:
            st = os.stat(path)
        except OSError:
            return False
        if (st.st_size, st.st_mtime_ns) == sig:
            return True
        res_skipped.pop(path, None)  # rewritten: decode it again
        return False

    def out_paths(path: str):
        stem = os.path.splitext(os.path.basename(path))[0]
        return (os.path.join(args.outdir, stem + ".png"),
                os.path.join(args.outdir, stem + ".npy"))

    with DepthServingEngine(model, input_size=args.input_size,
                            batch_size=args.batch_size,
                            device=args.device, runner=runner,
                            calib_batches=args.int8_calib) as engine:
        # Submit-then-drain in bounded chunks: a large pre-existing
        # backlog must not be decoded into host memory all at once.
        chunk = max(1, 4 * args.batch_size)
        while True:
            frames = sorted(
                f for pattern in ("*.png", "*.jpg", "*.jpeg")
                for f in glob.glob(os.path.join(args.input, pattern)))
            current = set(frames)
            # Deleted inputs drop out of the bookkeeping (a rotating
            # incoming/ dir stays bounded); already-written outputs keep
            # re-added inputs skipped via the exists() filter below.
            processed &= current
            stem_owner = {s: q for s, q in stem_owner.items()
                          if q in current}
            retries.prune(current)
            for gone in set(res_skipped) - current:
                res_skipped.pop(gone, None)
            unread = {}
            fresh = [f for f in frames
                     if f not in processed
                     and not res_parked(f)
                     and not os.path.exists(out_paths(f)[0])]
            n_done = 0
            for start in range(0, len(fresh), chunk):
                inflight = []
                for path in fresh[start:start + chunk]:
                    if retries.parked(path):
                        unread[path] = "parked"
                        continue  # stable-and-unreadable; stat-only skip
                    raw, why = _read_bgr(path)
                    if raw is None:
                        # Possibly a mid-upload partial file: retry while
                        # it is still changing; once stable AND unreadable
                        # it is parked until its signature changes again.
                        unread[path] = why
                        if retries.note_failure(path):
                            print(f"[serve] parking unreadable {path} "
                                  f"(will retry if it changes): {why}")
                        continue
                    retries.clear(path)
                    if export_hw and raw.shape[:2] != export_hw:
                        # Signature-keyed skip (not ``processed``): a file
                        # overwritten in place with a frame of the right
                        # size is picked back up.
                        try:
                            st = os.stat(path)
                            res_skipped[path] = (st.st_size, st.st_mtime_ns)
                        except OSError:
                            pass
                        print(f"[serve] skipping {path}: {raw.shape[:2]} "
                              f"!= exported frame {export_hw}")
                        continue
                    stem = os.path.splitext(os.path.basename(path))[0]
                    owner = stem_owner.setdefault(stem, path)
                    if owner != path:
                        print(f"[serve] skipping {path}: output stem "
                              f"collides with {owner}")
                        processed.add(path)
                        continue
                    inflight.append((path, engine.submit(raw)))
                    processed.add(path)
                for path, fut in inflight:
                    depth = fut.result()
                    png_path, npy_path = out_paths(path)
                    if args.save_numpy:
                        np.save(npy_path, depth)
                    write_png(png_path,
                              colorize_depth(depth, grayscale=args.grayscale),
                              bgr=True)
                n_done += len(inflight)
            served += n_done
            if n_done:
                print(f"[serve] processed {n_done} frames "
                      f"({len(processed)} tracked)")
            if args.once:
                stats = engine.stats()
                if stats.get("batches"):
                    print(f"[serve] stats: {stats['completed']} ok / "
                          f"{stats['failed']} failed in "
                          f"{stats['batches']} batches "
                          f"(mean fill {stats['mean_batch_fill']:.1f}); "
                          f"latency p50/p95/p99 = "
                          f"{stats.get('latency_p50_ms', 0):.0f}/"
                          f"{stats.get('latency_p95_ms', 0):.0f}/"
                          f"{stats.get('latency_p99_ms', 0):.0f} ms")
                for path, why in sorted(unread.items()):
                    print(f"[serve] left unread: {path}: {why}")
                break
            time.sleep(args.poll)
    return {"served": served, "unread": unread, "stats": engine.stats()}


if __name__ == "__main__":
    main()
