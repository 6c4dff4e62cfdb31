"""Framework-free copies of the reference's resilience accounting:
``core/goodput.py``, ``core/topology.py`` and ``core/ocs.py``; and
``core/sdc.py``, the FBIST self-test and replay checker over torch."""
