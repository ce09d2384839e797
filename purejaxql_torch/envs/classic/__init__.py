from purejaxql_torch.envs.classic.cartpole import CartPole, CartPoleParams, CartPoleState
