"""Cluster / Pod / Trainer topology and local process management for the
launcher (counterpart of paddle_tpu/distributed/launch_utils.py).

One trainer process a rank, each with the reference's PADDLE_* contract
(PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS,
PADDLE_CURRENT_ENDPOINT), PADDLE_LOCAL_RANK, and FLAGS_selected_gpus, the
card the trainer drives: trainer i of a host gets gpus[i % len(gpus)],
the cards from `--gpus` or CUDA_VISIBLE_DEVICES.  The rank-0 endpoint is
the rendezvous address of `init_parallel_env` (torch.distributed's TCP
store).  The first trainer to fail stops the others and its exit code is
the launcher's.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Trainer:
    endpoint: str
    rank: int
    accelerators: List[int] = field(default_factory=list)
    local_rank: int = 0


@dataclass
class Pod:
    ip: str
    trainers: List[Trainer] = field(default_factory=list)


@dataclass
class Cluster:
    pods: List[Pod] = field(default_factory=list)

    def trainers(self) -> List[Trainer]:
        return [t for p in self.pods for t in p.trainers]

    def endpoints(self) -> List[str]:
        return [t.endpoint for t in self.trainers()]

    def world_size(self) -> int:
        return len(self.trainers())

    def coordinator(self) -> str:
        return self.endpoints()[0]


def find_free_ports(n: int) -> List[int]:
    ports, socks = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def visible_gpus() -> List[int]:
    """The cards a host's trainers may take, as indices the trainers see:
    0..k-1 for the k ids of CUDA_VISIBLE_DEVICES, else every card torch
    counts (none without CUDA)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return list(range(len([v for v in vis.split(",") if v.strip()])))
    try:
        import torch

        return list(range(torch.cuda.device_count()))
    except Exception:  # noqa: BLE001 - no torch CUDA runtime: no cards
        return []


def get_cluster(node_ips: List[str], node_ip: str, started_port,
                nproc_per_node: int, gpus: Optional[List[int]] = None
                ) -> (Cluster, Pod):
    """Static topology: every node runs `nproc_per_node` trainers on
    consecutive ports from `started_port` (the reference's
    get_cluster_from_args contract); `started_port` may also be an
    explicit port list.  `gpus` are the cards of each node: trainer i
    of a node drives gpus[i % len(gpus)]."""
    ports = (list(started_port) if isinstance(started_port, (list, tuple))
             else [started_port + i for i in range(nproc_per_node)])
    cluster = Cluster()
    rank = 0
    current = None
    for ip in node_ips:
        pod = Pod(ip=ip)
        for i in range(nproc_per_node):
            acc = [gpus[i % len(gpus)]] if gpus else []
            pod.trainers.append(
                Trainer(endpoint=f"{ip}:{ports[i]}", rank=rank,
                        accelerators=acc, local_rank=i))
            rank += 1
        cluster.pods.append(pod)
        if ip == node_ip:
            current = pod
    if current is None:
        raise ValueError(f"node_ip {node_ip} not in --ips {node_ips}")
    return cluster, current


@dataclass
class TrainerProc:
    proc: subprocess.Popen
    rank: int
    log_fh: Optional[object] = None


def trainer_env(cluster: Cluster, trainer: Trainer,
                extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """A trainer's environment: the reference's PADDLE_* contract,
    PADDLE_LOCAL_RANK and FLAGS_selected_gpus."""
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(trainer.rank),
        "PADDLE_CURRENT_ENDPOINT": trainer.endpoint,
        "PADDLE_TRAINERS_NUM": str(cluster.world_size()),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(cluster.endpoints()),
        "PADDLE_LOCAL_RANK": str(trainer.local_rank),
    })
    if trainer.accelerators:
        env["FLAGS_selected_gpus"] = ",".join(
            str(a) for a in trainer.accelerators)
    if extra:
        env.update(extra)
    return env


def start_local_trainers(cluster: Cluster, pod: Pod, cmd: List[str],
                         log_dir: Optional[str] = None,
                         extra_env: Optional[Dict[str, str]] = None
                         ) -> List[TrainerProc]:
    procs = []
    for t in pod.trainers:
        env = trainer_env(cluster, t, extra_env)
        fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fh = open(os.path.join(log_dir, f"workerlog.{t.rank}"), "w")
        p = subprocess.Popen(cmd, env=env, stdout=fh or None,
                             stderr=subprocess.STDOUT if fh else None)
        procs.append(TrainerProc(proc=p, rank=t.rank, log_fh=fh))
    return procs


def terminate_local_trainers(procs: List[TrainerProc]):
    for tp in procs:
        if tp.proc.poll() is None:
            try:
                tp.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
    deadline = time.time() + 10
    for tp in procs:
        try:
            tp.proc.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            tp.proc.kill()
    for tp in procs:
        if tp.log_fh:
            tp.log_fh.close()


def watch_local_trainers(procs: List[TrainerProc],
                         poll_s: float = 0.5) -> int:
    """Block until all trainers exit.  The first non-zero exit stops the
    rest; returns that exit code, or 0."""
    try:
        while True:
            alive = False
            for tp in procs:
                rc = tp.proc.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    terminate_local_trainers(procs)
                    return rc
            if not alive:
                return 0
            time.sleep(poll_s)
    except KeyboardInterrupt:
        terminate_local_trainers(procs)
        raise
