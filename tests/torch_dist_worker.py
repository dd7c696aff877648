"""One rank of the gloo groups of ``tests/test_torch_distributed.py``:
imports torch and the port only (no JAX), so a spawned rank starts fast."""

import datetime

import torch
import torch.distributed as dist


def run_step(rank: int, world: int, init_file: str, in_path: str, out_dir: str,
             two_level: bool) -> None:
    """Join a ``world``-rank gloo group through ``init_file``, take one
    train step on the port (data 2, or dcn 2 x data 1) from the tree and
    tokens in ``in_path`` with AdamW(1e-3, weight decay 0.1), and save the
    new params, state and loss under ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        from bobrapet_tpu_torch.models import llama
        from bobrapet_tpu_torch.parallel import mesh, optim, train

        data = torch.load(in_path)
        cfg = llama.llama_tiny()
        opt = optim.adamw(1e-3, weight_decay=0.1)
        if two_level:
            m, step = train.make_multislice_train_step(cfg, 2, {"data": 1}, device_type="cpu",
                                                       optimizer=opt)
        else:
            m = mesh.build_mesh({"data": 2}, device_type="cpu")
            step = train.make_train_step(cfg, m, optimizer=opt)
        params, state, loss = step(data["params"], opt.init(data["params"]), data["tokens"])
        torch.save({"params": params, "state": state, "loss": loss,
                    "axes": dict(zip(m.mesh_dim_names, m.shape))},
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
