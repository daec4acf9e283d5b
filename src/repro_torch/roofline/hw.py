"""Target-hardware constants: the NVIDIA H100 SXM5, from its datasheet
(not measured). The card the port runs on reports itself to ``nvidia-smi
--query-gpu=name,power.limit`` as below; a card set below 700 W runs
slower under load than these peaks.

The mesh's collectives: within an 8-GPU HGX node every GPU reaches every
other through NVSwitch at NVLink 4's 900 GB/s (450 GB/s each way); across
nodes each GPU has one 400 Gb/s NDR InfiniBand link, 50 GB/s each way. The
production meshes' "model" axis is 16 wide, so it spans two nodes, and a
ring collective over it moves its bytes through the inter-node links at
their pace: ``collective_s`` divides by ``COLLECTIVE_BW``, the
inter-node figure, the slowest link every 16-wide collective crosses.
"""

CARD_NAME = "NVIDIA H100 80GB HBM3"
POWER_LIMIT = "700.00 W"

PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor-core FLOP/s, per GPU
HBM_BW = 3.35e12               # HBM3 bytes/s, per GPU
HBM_BYTES = 80 * 10**9         # 80 GB per GPU
SMS = 132                      # streaming multiprocessors, per GPU
NVLINK_BW = 450e9              # bytes/s each way, per GPU, within a node
INTERNODE_BW = 50e9            # bytes/s each way, per GPU, between nodes
COLLECTIVE_BW = INTERNODE_BW   # what collective_s divides by (see above)
