"""The collective launcher (counterpart of paddle_tpu/distributed/
launch.py):

    python -m paddle_tpu_torch.distributed.launch [--ips ip1,ip2] \\
        [--nproc_per_node N] [--gpus 0,1] [--started_port P] \\
        [--log_dir dir] train.py [script args...]

builds the Cluster / Pod topology from --ips (localhost by default),
starts N trainers a node under the PADDLE_* contract with
FLAGS_selected_gpus (trainer i takes gpus[i % len(gpus)]; the cards of
--gpus, else CUDA_VISIBLE_DEVICES, else all), and exits with the first
nonzero exit code of a trainer.  The trainers run NCCL on their cards
unless PADDLE_DISTRI_BACKEND=gloo is set (several ranks may then share
a card).  There is no parameter-server mode.
"""

from __future__ import annotations

import argparse
import sys

from .launch_utils import (find_free_ports, get_cluster, start_local_trainers,
                           visible_gpus, watch_local_trainers)


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="paddle_tpu_torch collective launcher")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated host ips (rank order)")
    p.add_argument("--node_ip", type=str, default=None,
                   help="this node's ip (default: first of --ips)")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="trainers a node (default: one a card)")
    p.add_argument("--gpus", type=str, default=None,
                   help="comma-separated cards of a node (default: "
                        "CUDA_VISIBLE_DEVICES, else every card)")
    p.add_argument("--started_port", type=int, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch_collective(args) -> int:
    gpus = [int(g) for g in args.gpus.split(",")] if args.gpus \
        else visible_gpus()
    nproc = args.nproc_per_node or max(1, len(gpus))
    ips = [s.strip() for s in args.ips.split(",") if s.strip()]
    node_ip = args.node_ip or ips[0]
    if args.started_port:
        port = args.started_port
    elif len(ips) == 1:
        # one node: ports free now, so concurrent jobs do not collide
        port = find_free_ports(nproc)
    else:
        port = 8476  # several nodes need a base port agreed beforehand
    cluster, pod = get_cluster(ips, node_ip, port, nproc, gpus)
    cmd = [sys.executable, "-u", args.training_script] \
        + args.training_script_args
    procs = start_local_trainers(cluster, pod, cmd, log_dir=args.log_dir)
    return watch_local_trainers(procs)


def main(argv=None):
    rc = launch_collective(_parse_args(argv))
    if rc != 0:
        sys.exit(rc if rc > 0 else 128 - rc)


if __name__ == "__main__":
    main()
