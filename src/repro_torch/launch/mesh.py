"""Process group and mesh construction. Functions, not module-level
constants, so importing this module touches no process group.

``init_world`` joins the default process group (NCCL on ``cuda``, gloo on
``cpu``): under ``torchrun`` from its environment, otherwise from the
rank, world size and ``tcp://localhost`` port the caller gives.
``make_local_mesh`` lays that world out as a ``("data", "model")``
``DeviceMesh``; ``make_production_mesh`` lays out the 256- or 512-card
world of the dry run (``launch/dryrun.py``), which a fake process group
of that size provides on any host.
"""

from __future__ import annotations

import math
import os
import socket

import torch

from repro_torch.device import resolve_device


def free_port() -> int:
    """A TCP port on localhost that is free now (for a rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def under_torchrun() -> bool:
    """True when ``torchrun`` (or another launcher) set this process's
    rank and world size."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_world(device=None, *, rank: int = 0, world_size: int = 1,
               port: int | None = None) -> torch.device:
    """Join the default process group on ``device`` (default ``cuda``):
    NCCL on the card (each rank on ``cuda:LOCAL_RANK``), gloo on the CPU.
    Under ``torchrun`` the rank, the world and the rendezvous come from
    its environment; otherwise from ``rank``, ``world_size`` and
    ``tcp://localhost:port``. Returns this rank's device. A failed init
    raises."""
    import torch.distributed as dist
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if under_torchrun():
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        method = "env://"
    else:
        if port is None:
            raise ValueError("init_world needs a port outside torchrun")
        method = f"tcp://localhost:{port}"
    kw = {}
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if cuda else "gloo", init_method=method,
                            world_size=world_size, rank=rank, **kw)
    return dev


def make_local_mesh(model_parallel: int = 1, device=None):
    """The default process group's world as a ``(world / model_parallel,
    model_parallel)`` ``("data", "model")`` ``DeviceMesh`` on ``device``'s
    type (default ``cuda``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs the default process "
                           "group (init_world)")
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world of {n}")
    return init_device_mesh(resolve_device(device).type,
                            (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


# the production meshes: HGX H100 nodes of 8 cards, NVLink within a node
PRODUCTION_SHAPE = {False: (32, 8), True: (2, 32, 8)}
PRODUCTION_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production H100 mesh over the default process group: ``(32,
    8)`` ``("data", "model")``, 256 cards, or ``(2, 32, 8)`` ``("pod",
    "data", "model")``, 512 (JAX's chip counts and axis names). The model
    axis is 8 because an HGX H100 node's NVLink domain is 8 cards: a
    16-way model axis, as on the TPU, would put every tensor-parallel
    collective on the network. The ``pod`` axis is the second network hop;
    gradient reduction composes ``(pod, data)`` (``sharding/rules.py``).

    The world must already have that many ranks: on real cards through
    ``init_world``, or, for the dry run, a fake process group of 256 or
    512 (``torch.testing._internal.distributed.fake_pg``), which gives a
    real ``DeviceMesh`` on one host with nothing allocated or sent."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = PRODUCTION_SHAPE[multi_pod]
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"make_production_mesh needs a default process "
                           f"group of {n} ranks")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=PRODUCTION_AXES[multi_pod])
