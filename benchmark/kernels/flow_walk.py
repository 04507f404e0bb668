"""K4, ``csrc/walk.cu``'s jump walk (entry ``launch_jump_walk``): phase 1
(``jump_start_kernel``) and the pointer-jumping rounds
(``jump_round_kernel``).

Read: ``fdr_eff`` and ``code0``, int32 (8 B a cell, built by
``ops/flow.walk_inputs``).  Written: the absorber code and the cardinal
and diagonal step counts, int32 (12 B).  20 B a cell.  The rounds'
rereads of the pending cells' state and the 28 B of scratch a cell are
the kernel's own traffic, not what these inputs need."""

NAMES = ("jump_start_kernel", "jump_round_kernel")


def bytes_moved(cells, operands):
    return (4 + 4 + 3 * 4) * cells
