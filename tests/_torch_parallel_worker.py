"""A rank of the port's data-parallel train step, for
``test_torch_parallel.py``: spawned by ``commu_tpu_torch.parallel.spawn``
(gloo, on the CPU), it trains from the weights and global batches it is
handed, feeding its own rows, and rank 0 saves the metrics of every step
and the final weights.  Imports torch and the port only."""
import torch

from commu_tpu_torch.models import TransformerXL, init_memory
from commu_tpu_torch.parallel import multihost as mh
from commu_tpu_torch.training import make_optimizer, make_train_step


def run_rank(rank, device, cfg, state_dict, batches, out_path):
    world = mh.process_count()
    model = TransformerXL(729, cfg.model, dtype=torch.float32)
    model.load_state_dict(state_dict)
    model = model.to(device)
    opt, sched = make_optimizer(model, cfg, world)
    step = make_train_step(model, opt, sched, cfg)
    batch = cfg.train.batch_size
    rows = mh.process_batch_slice(batch)
    memory = init_memory(cfg.model.num_layers, batch // world,
                         cfg.train.mem_length, cfg.model.units,
                         block_len=cfg.train.tgt_length, device=device)
    metrics = []
    for inputs, targets, reset in batches:
        memory, m = step(memory, *(torch.from_numpy(x[rows]).to(device)
                                   for x in (inputs, targets, reset)))
        metrics.append({k: float(v) for k, v in m.items()})
    if rank == 0:
        torch.save({"metrics": metrics, "world": world,
                    "state": {k: v.cpu() for k, v in
                              model.state_dict().items()}}, out_path)
