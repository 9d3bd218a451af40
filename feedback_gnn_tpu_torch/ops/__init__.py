from .dense import dense_bl
from .gf2mat import mod2_matmul
