"""The tuning path's probes: each measures kernel variants on the card and
prints one JSON line a measurement (``python -m
ggmlsharp_tpu_torch.probes.<name>``):

  * ``dq_variants``: the Q4_0 dequant-matmul's nibble-to-number step in
    three builds of ``csrc/matmul_q4_0.cu`` (``Q4_UNPACK``), and the card's
    copy ceiling (``csrc/probes.cu``);
  * ``swar``: the byte order of the Q4 kernels' loads and a K-major Q4_0
    layout (``csrc/matmul_q4_0_kmajor.cu``) against the row layout;
  * ``scale_decode``: the kernels' f16 scale load over every pattern, their
    element-to-scale maps and the bad-entry map of a Q4_0 matmul.

Counterparts of ``scripts/probe_dq_variants.py``, ``scripts/probe_swar.py``
and ``scripts/diag_chunked10.py``. Each runs on the card unless the caller
asks for the CPU (``--device cpu``), where only the plain versions run, at a
small size, and no time is taken.
"""
