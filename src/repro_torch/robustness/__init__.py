from .integrity import checked_npz_load, quarantine_file
from .report import BUCKETS, RobustnessReport, current_report, report_scope

__all__ = ["BUCKETS", "RobustnessReport", "checked_npz_load",
           "current_report", "quarantine_file", "report_scope"]
