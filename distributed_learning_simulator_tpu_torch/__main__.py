"""``python -m distributed_learning_simulator_tpu_torch`` — same CLI as
``python -m distributed_learning_simulator_tpu_torch.simulator``. With
``--sweep_seeds`` / ``--sweep_points`` set, the process runs a
multi-experiment sweep (sweep/engine.py) instead of one simulation."""

from distributed_learning_simulator_tpu_torch.simulator import main

if __name__ == "__main__":
    main()
