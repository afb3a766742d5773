"""A training job for the SIGKILL resume checks: PaddleRec's CTR-DNN
(tests/torch_ctr_program.py) trained through the port's
Executor.train_from_dataset, its auto-checkpoint configured only through
the PADDLE_CKPT_* environment variables (read when fluid/flags.py is
imported, as the reference reads them).  JAX-free: tests/test_torch_ckpt.py
runs it on the CPU, chip_smoke.py on the card.

After each step it appends one fsync'd line `<executor step> <loss>` to
the output file, and with KILL_AT_STEP it SIGKILLs itself at that
executor step's boundary (after the step's checkpoint was enqueued, so
the kill may land in an asynchronous write and leave a tmp dir).

    python tests/torch_ckpt_worker.py OUT

env:
    DATA_DIR       MultiSlot files (torch_ctr_program.write_files)
    CTR_CFG        "SMALL" (default) or a JSON dict of torch_ctr_program
                   config keys over SMALL (a cut width)
    DEVICE         "cpu" (default) or "cuda"
    EPOCHS         passes over the data (default 1)
    SHUFFLE_SEED   the in-memory shuffle's seed (default 7)
    KILL_AT_STEP   SIGKILL at this executor step (-1: never)
    PADDLE_CKPT_*  the auto-checkpoint knobs (dir, cadence, retention)
"""

import json
import os
import signal
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

import torch_ctr_program as C  # noqa: E402
import paddle_tpu_torch.fluid as fluid  # noqa: E402


def config():
    raw = os.environ.get("CTR_CFG", "SMALL")
    return C.SMALL if raw == "SMALL" else dict(C.SMALL, **json.loads(raw))


def main():
    out_path = sys.argv[1]
    data_dir = os.environ["DATA_DIR"]
    cfg = config()
    epochs = int(os.environ.get("EPOCHS", "1"))
    kill_at = int(os.environ.get("KILL_AT_STEP", "-1"))
    seed = int(os.environ.get("SHUFFLE_SEED", "7"))
    device = os.environ.get("DEVICE", "cpu")
    files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir))
    main_prog, startup, out = C.build(fluid, cfg)
    exe = fluid.Executor(fluid.CPUPlace() if device == "cpu" else None)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    ds = C.dataset(fluid, "InMemoryDataset", out["feeds"], files, cfg,
                   seed=seed)
    with open(out_path, "a") as f:
        def on_step(step, step_in_epoch, fetches):
            f.write(f"{step} {float(np.asarray(fetches[0])):.9g}\n")
            f.flush()
            os.fsync(f.fileno())
            if step == kill_at:
                os.kill(os.getpid(), signal.SIGKILL)  # preemption

        for _ in range(epochs):
            exe.train_from_dataset(main_prog, ds, scope=scope,
                                   fetch_list=[out["loss"]],
                                   step_callback=on_step)
    print("worker done", flush=True)


if __name__ == "__main__":
    main()
