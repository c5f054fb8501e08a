"""Device idle share of a trained run's train step on the CUDA card.

Takes the train CLI's flags (``python -m gflownet_spai_tpu_torch.train``),
restores the newest checkpoint under ``--out-dir`` (the launchers' runs),
and times train steps from that state: wall ms per step on the host clock
(synchronised) and device busy ms per step under ``torch.profiler``, so the
idle share is read on the trajectories the trained policy samples.

    PYTHONPATH=. python examples/profile_train_torch.py <train flags>
        --out-dir RUN [--steps N]

Prints the card's name and power limit beside the numbers; writes nothing.
"""

import subprocess
import sys
import time


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gflownet_spai_tpu_torch.train.__main__ import build_parser
    from gflownet_spai_tpu_torch.train.config import TrainConfig
    from gflownet_spai_tpu_torch.train.enums import reconcile
    from gflownet_spai_tpu_torch.train.loop import (make_train_step, restore_checkpoint,
                                                    setup)

    argv = list(sys.argv[1:] if argv is None else argv)
    steps = 20
    if "--steps" in argv:
        i = argv.index("--steps")
        steps = int(argv[i + 1])
        del argv[i:i + 2]
    args = build_parser().parse_args(argv)
    cfg = TrainConfig(**{k: v for k, v in vars(args).items()
                         if k not in ("legacy", "multihost")})
    _, _, env, graph, mcfg, opt, state = setup(cfg)
    restored = restore_checkpoint(cfg.out_dir, state)
    if restored is None:
        raise SystemExit(f"no checkpoint under {cfg.out_dir}/checkpoint")
    state, _ = reconcile(cfg.out_dir, env, restored, backward=cfg.backward)
    step = make_train_step(cfg, env, graph, mcfg, opt)
    box = [state]

    def run():
        box[0], m = step(box[0])
        return float(m["mean_len"])

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lens = [run() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / steps
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / steps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    print(f"restored epoch {restored.epoch}: {steps} steps, mean length "
          f"{sum(lens) / len(lens):.1f}; wall {wall:.3f} ms/step; under "
          f"torch.profiler {prof_wall:.3f} ms/step wall, device busy {busy:.3f} "
          f"ms/step, idle share {100 * (1 - busy / prof_wall):.1f}%")


if __name__ == "__main__":
    main()
