from .golden import GoldenDynamics
