from tpuseg_torch.nn.sru import SRU, SRUCell, sru_recurrence

__all__ = ["SRU", "SRUCell", "sru_recurrence"]
