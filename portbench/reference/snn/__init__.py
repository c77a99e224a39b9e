"""A frozen plain copy of the port's spiking models (MS and SEW
spikeformer U-Nets), taken from ``sdformerflow_tpu_torch/models`` and
``ops`` with every hand kernel replaced by its plain twin: the PSN site is
:func:`plain.affine_psn` (K2's twin), the MS QK attention always runs its
module form (K1's twin), and no data-parallel group is ever active. Module
and parameter names are the program's, so one state_dict loads into both.

Nothing here imports the program: the files are copies, edited only where
they reached a kernel or the multi-process layer (``plain.py``)."""
