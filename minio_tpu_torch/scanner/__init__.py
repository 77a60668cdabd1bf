"""Background services, the port of minio_tpu.scanner (reference §2.4):
the MRF heal queue that degraded reads and partial writes feed
(``mrf.MRFHealer`` over ``park.DebtQueue``), the data scanner and its
usage accounting (``scanner``, ``usage``, the change ``tracker``), the
durability ``janitor``, fresh-disk auto-heal (``autoheal``) and the admin
heal sequences (``healseq``)."""


def background_heal_stats(server) -> dict:
    """Stats of the heal services attached to a server (autoheal, mrf):
    the admin bg-heal-status op's document."""
    out = {}
    for name in ("autoheal", "mrf"):
        svc = getattr(server, name, None)
        stats = getattr(svc, "stats", None)
        if callable(stats):
            out[name] = stats()
    return out
