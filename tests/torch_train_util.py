"""Helpers shared by the port's training tests (no JAX here): one torch
thread while a test module runs (the CPU tests run several workers at once,
and torch's default thread pool on a shared machine makes the small ops of
a tiny model some 40 times slower), and the tiny model's configuration."""
import pytest
import torch

D, V = 80, 12
ENC = dict(output_size=32, attention_heads=4, linear_units=64, num_blocks=2,
           cnn_module_kernel=15, block_final_norm=False)
DEC = dict(attention_heads=4, linear_units=64, num_blocks=1, r_num_blocks=1)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
