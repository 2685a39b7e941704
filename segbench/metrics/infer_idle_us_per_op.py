"""The card's idle time of the traced inference window over its device
events (us): what each dispatched operation costs the card in waiting."""


def read(ctx):
    if "batches" not in ctx:
        return None
    s = ctx["summary"]
    return 1e6 * (s["window_s"] - s["busy_s"]) / s["ops"]
