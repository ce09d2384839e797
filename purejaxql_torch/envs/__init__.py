from purejaxql_torch.envs import spaces, wrappers
from purejaxql_torch.envs.base import Environment, Wrapper
from purejaxql_torch.envs.registry import make
