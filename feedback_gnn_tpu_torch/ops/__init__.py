from .dense import dense_bl, init_dense, init_mlp, mlp_bl
from .gf2mat import mod2_matmul
