#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 17 (the viewers, CLIP guidance, the brick
grid) alone on one NVIDIA GPU: build the kernels, write phase 11's scene
and train ``main_nerf -O`` on it as phase 11 (a) does (``CLI_ITERS``),
write the dynamic scene and train ``main_dnerf -O`` as phase 16 (a) does
(``DNERF_ITERS``), then call ``viewer_runs``, ``clip_runs`` and
``brick_runs`` on those workspaces. About five minutes of command time.

    python3 scripts/torch_phase17.py
"""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke as cs
    from ngp_tpu_torch import main_dnerf, main_nerf
    from ngp_tpu_torch.data.synthetic import make_synthetic_dataset
    from ngp_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_phase17: no CUDA device; this script runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print("card:", card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    build.build()
    build.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    n_train, n_val, n_test = cs.CLI_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene = make_synthetic_dataset(os.path.join(tmp, "scene"), n_train=n_train,
                                       n_val=n_val, n_test=n_test, device=dev)
        main_nerf.main([scene, "-O", "--workspace", os.path.join(tmp, "cli", "ws"), "--iters",
                        str(cs.CLI_ITERS)], device=dev)
        dscene = make_synthetic_dataset(os.path.join(tmp, "dnerf", "dscene"), n_train=n_train,
                                        n_val=n_val, n_test=n_test, dynamic=True, device=dev)
        main_dnerf.main([dscene, "-O", "--workspace", os.path.join(tmp, "dnerf", "ws"),
                         "--iters", str(cs.DNERF_ITERS)], device=dev)
        print(f"setup {time.perf_counter() - t0:.1f} s", flush=True)
        runs = (("17a", lambda: cs.viewer_runs(dev, card, scene, os.path.join(tmp, "cli", "ws"),
                                                dscene, os.path.join(tmp, "dnerf", "ws"))),
                ("17b", lambda: cs.clip_runs(dev, card, scene, tmp)),
                ("17c", lambda: cs.brick_runs(dev, card, scene, tmp, {}, {})))
        for name, run in runs:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    print("phase 17: ok")


if __name__ == "__main__":
    main()
