"""Background services, the port of minio_tpu.scanner (reference §2.4): so
far the MRF heal queue that degraded reads and partial writes feed
(``mrf.MRFHealer`` over ``park.DebtQueue``). The data scanner, usage
accounting, auto-heal and the heal sequences wait for their slice."""
