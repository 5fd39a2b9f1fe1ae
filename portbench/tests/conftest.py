import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    import torch

    # several test workers share the CPU: one thread each
    torch.set_num_threads(1)
