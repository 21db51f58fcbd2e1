from .robot import RobotModel, load_robot, robot_model_from_description
from .topology import Topology
from .urdf import RobotDescription, parse_urdf
from . import zoo
