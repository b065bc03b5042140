"""Operations and bytes of each operation, from its shapes alone (never
from the kernel that runs it). Each returns (flops, bytes)."""
