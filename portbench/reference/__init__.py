"""The benchmark's plain reference: a GroundGrid written from the published
algorithm in plain PyTorch, importing nothing of the system under test."""
