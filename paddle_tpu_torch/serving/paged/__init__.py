from .pool import TRASH_BLOCK, PagedAllocation, PagedKVPool
from .radix import RadixPrefixIndex

__all__ = ["TRASH_BLOCK", "PagedAllocation", "PagedKVPool",
           "RadixPrefixIndex"]
