"""Training over several devices (port of ``cfun_tpu/parallel``): the
('data', 'space') mesh over ``torch.distributed`` ranks and the parallel
step (``mesh.py``), the collectives of the split trunk and U-Net
(``halo.py``), and the start of the ranks (``launch.py``)."""
