"""Fleet scaling: vehicles stepped in lock-step over a list of devices
(``sharding.py``) and across processes with ``torch.distributed``
(``multihost.py``)."""
