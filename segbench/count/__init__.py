"""The benchmark's own yardstick of work: the card's published peaks and
the bound of one ``ir_chain`` call (``peaks``), and the operations a
batch or a training step needs, counted on the plain reference
(``flops``)."""
