"""Framework-free copies of the reference's paper models: Table 1
(``core/hwspec.py``), Figure 5-6 carbon intensity (``core/cci.py``), the
three-term roofline (``core/roofline.py``, over the two cost records of
``core/hlo_analysis.py``), resilience accounting (``core/goodput.py``,
``core/topology.py``, ``core/ocs.py``); and ``core/sdc.py``, the FBIST
self-test and replay checker over torch."""
