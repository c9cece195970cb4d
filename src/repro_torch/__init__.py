"""PyTorch/CUDA port of the parameter-efficient FEEL reproduction.

A second package beside ``repro`` (the JAX reference, which it never
imports). It runs the paper's pipeline — Dirichlet split of
synthetic-mnist or synthetic-cifar10, phi, the AO schedule
(`core.optimizer_ao.solve_p1`), and pruned FedSGD or a local-update scheme
(FedAvg, FedProx, FedDyn) on LeNet / mlp-edge / ResNet-CIFAR
(`core.federated.FederatedTrainer`) — with the round's Pallas kernels
replaced by hand-written CUDA kernels for Hopper (`kernels/`). It also
serves the LM stack's dense and ssm families (`configs/`,
`models/transformer.py`, `serving/`, `launch/serve.py`) through the
attention and SSD kernels. Entry points run on CUDA unless given
device="cpu".
"""
