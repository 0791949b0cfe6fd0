"""Training over several devices (port of ``cfun_tpu/parallel``): the
('data', 'space') mesh over ``torch.distributed`` ranks and the parallel
step (``mesh.py``), the D-split U-Net's halo exchanges and sharded mask
losses (``halo.py``), and the start of the ranks (``launch.py``)."""
