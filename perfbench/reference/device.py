"""How many processes share this process's card: the reference runs alone
(the port's device.py ranks_per_card, as one process has it)."""


def ranks_per_card() -> int:
    return 1
