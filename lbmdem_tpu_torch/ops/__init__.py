"""PyTorch ops of the port: plain versions (CPU tensors) and wrappers of
the hand-written CUDA kernels (CUDA tensors)."""


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error every out-of-slice path raises: it names the ROADMAP.md
    item ("Modules to port, in order") that will port it."""
    return NotImplementedError(
        f"{what} is not ported to lbmdem_tpu_torch yet "
        f"(ROADMAP.md, 'Modules to port, in order', item {item})"
    )
