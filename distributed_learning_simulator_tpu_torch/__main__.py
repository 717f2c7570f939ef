"""``python -m distributed_learning_simulator_tpu_torch`` — same CLI as
``python -m distributed_learning_simulator_tpu_torch.simulator``."""

from distributed_learning_simulator_tpu_torch.simulator import main

if __name__ == "__main__":
    main()
