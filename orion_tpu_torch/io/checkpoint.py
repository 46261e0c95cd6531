"""Resumable render accumulation (checkpoint / resume).

The PyTorch counterpart of `orion_tpu.io.checkpoint`. The reference has no
render checkpointing; long renders should survive preemption, so they run
in sample chunks and persist (accumulated radiance, samples done, seed,
the render generator's state) after each chunk; re-running with the same
checkpoint path resumes where it stopped.

Determinism: every uniform of a render comes from one `torch.Generator`
seeded with `seed`, and the standard route draws per sample, in order
(render.py). The checkpoint stores the generator's state after its last
chunk and the resume restores it, so a render interrupted and resumed
after any chunk equals a one-shot render of the same seed and sample
count, whatever the chunk size. The regen route (regen=True) draws its
uniforms per chunk in the order its wavefront needs them, so its image
also depends on the chunk size: resume with the same `every`.

Sharded (`mesh=`): chunks go through parallel/shardmap_render.py (or the
regen route's render_regen_shardmap). Every rank holds the same
generator; the stored state is that shared generator's, and each rank
derives its own stream from it (the rank fold), so a resume on the same
world size continues every rank's stream. The config tag names the world
size: a file written by another world size starts over.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def save_checkpoint(path: str | Path, accum: np.ndarray, samples_done: int,
                    seed: int, rng_state: np.ndarray,
                    config: str = "") -> None:
    """Atomic save: write to a temp file in the same directory, then rename.

    `rng_state` is the render generator's `get_state()` as uint8; `config`
    is an opaque render-configuration tag (see render_accumulate)."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent or Path("."),
                               suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, accum=accum, samples_done=np.int64(samples_done),
                     seed=np.int64(seed),
                     rng_state=np.asarray(rng_state, np.uint8),
                     config=np.str_(config))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# what save_checkpoint writes; a file that lacks any of them (the JAX
# package's format: accum, samples_done, key_data, config) is no
# checkpoint of this package
KEYS = ("accum", "samples_done", "seed", "rng_state", "config")


def load_checkpoint(path: str | Path):
    """(accum, samples_done, seed, rng_state, config), or None if the file
    is absent or lacks one of those keys (render_accumulate then starts
    over and overwrites it, as the JAX package does with a file that has
    no config)."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path) as z:
        if any(k not in z for k in KEYS):
            return None
        return (z["accum"], int(z["samples_done"]), int(z["seed"]),
                z["rng_state"], str(z["config"]))


def _progress_line(done: int, samples: int, chunk_rays: int,
                   chunk_seconds: float, start_done: int,
                   elapsed: float) -> str:
    """One progress line per chunk: samples done, rays/s, ETA (the
    reference's per-scanline tqdm bar, raytracer.cpp:66-68)."""
    rate = chunk_rays / max(chunk_seconds, 1e-9)
    done_since = done - start_done
    eta = (samples - done) * elapsed / max(done_since, 1)
    return (f"[render] {done}/{samples} spp  "
            f"{rate / 1e6:.2f}M primary rays/s  "
            f"chunk {chunk_seconds:.1f}s  ETA {eta:.0f}s")


def render_accumulate(ps, seed: int, *, samples: int, light_samples: int,
                      max_depth: int, mode: Optional[str],
                      path: str | Path, every: int = 64,
                      regen: bool = False, mesh=None,
                      progress: bool = True) -> np.ndarray:
    """Render `samples` spp of the prepared scene `ps` in chunks of `every`
    with checkpointed accumulation; returns the mean radiance image.
    Resumes from `path` when it exists and matches (same seed, same
    configuration); any other checkpoint there is started over and
    overwritten. `progress=True` prints one progress line per chunk on
    stderr.

    Chunks go through engine.render_wavefront: the wavefront (render.py)
    over the scene's intersect, without normal maps, or with `regen=True`
    the regenerative wavefront (regen.py; path mode only).

    mesh: a parallel.sharding.Mesh whose ranks all call this with the
    same arguments: chunks render through render_wavefront(mesh=)
    (render_shardmap or render_regen_shardmap), every rank returns the
    image, rank 0 alone reads and writes the file (the others get its
    resume state by one broadcast, and wait at a barrier after each
    write), and only rank 0 prints progress.
    """
    from orion_tpu_torch.engine import render_wavefront

    if regen and (mode == "whitted"
                  or (mode is None and ps.scene.num_lights > 0)):
        raise ValueError(
            "regen=True is path-mode only (render_regen has no Whitted "
            "support); this scene would render Whitted")

    dev = ps.scene.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    H, W = ps.camera.yres, ps.camera.xres
    accum = np.zeros((H, W, 3), np.float32)
    done = 0

    # the estimator configuration this accumulation is valid under (mixing
    # two would silently average two estimators into one image), and the
    # generator's device type: a CPU state cannot seed a CUDA generator
    resolved_mode = (mode if mode is not None
                     else ("whitted" if ps.scene.num_lights > 0 else "path"))
    world = 1 if mesh is None else mesh.world
    lead = mesh is None or mesh.rank == 0
    config = (f"mode={resolved_mode};max_depth={max_depth};"
              f"light_samples={light_samples};regen={bool(regen)}"
              + (f";every={every}" if regen else "")
              + f";device={dev.type};world={world}")

    ck = load_checkpoint(path) if lead else None
    resume = None
    if ck is not None:
        c_accum, c_done, c_seed, c_state, c_config = ck
        if (c_accum.shape == accum.shape and c_seed == seed
                and c_config == config):
            resume = (np.asarray(c_accum, np.float32), c_done,
                      np.array(c_state, np.uint8))
    if mesh is not None:
        from orion_tpu_torch.parallel.distributed import (barrier,
                                                          broadcast_object)

        resume = broadcast_object(resume, mesh)
    if resume is not None:
        accum, done, state = resume
        gen.set_state(torch.from_numpy(state))

    start_done, t_start = done, time.perf_counter()
    while done < samples:
        t_chunk = time.perf_counter()
        n = min(every, samples - done)
        img = render_wavefront(ps, gen, samples=n,
                               light_samples=light_samples,
                               max_depth=max_depth, mode=mode, regen=regen,
                               mesh=mesh)
        accum = accum + img.cpu().numpy().astype(np.float32) * n
        done += n
        if lead:
            save_checkpoint(path, accum, done, seed,
                            gen.get_state().numpy(), config)
        if mesh is not None:
            barrier(mesh)
        if progress and lead:
            print(_progress_line(done, samples, n * H * W,
                                 time.perf_counter() - t_chunk, start_done,
                                 time.perf_counter() - t_start),
                  file=sys.stderr, flush=True)

    return accum / float(max(done, 1))
