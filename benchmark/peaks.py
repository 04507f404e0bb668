"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, SXM parts, dense rates), by the name ``torch.cuda.get_device_name``
gives.  They assume the card's full power limit (700 W for the H100 SXM);
the run prints the card's limit beside every share of a peak."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12),
}


def for_card(kind):
    """The card's peaks, or None for a card not in the table."""
    return PEAKS.get(kind)
